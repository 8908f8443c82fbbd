"""The trace of ``Sweep.run``: one record a sweep, its spans and its byte
counters.

A record is kept for a ``Sweep.run`` when, at the call's entry, a
``torch.profiler`` session is recording or the call runs inside ``with
recording():``.  That is read once a run; otherwise the run keeps no
record, enters no ``record_function``, records no CUDA event and reads
nothing back from the card, and each span site costs one ``if``.

Spans (name, parent, start and end from ``time.perf_counter_ns()``):

    sweep.run       the whole ``Sweep.run``
      sweep.stage     the stage cache's lookup, initial state, parameters,
                      the mesh cut, and on a miss stacking, padding and
                      dense rows (``Sweep._prepare``)
      sweep.plan      ``pack_react_rows``, ``mega_rows``, and on a miss
                      ``reduce_plan`` and ``mega_tables``
      sweep.lookup    the window runner: signature, cache, ``bind``
        sweep.capture   a miss only: the entry built (warm-up, capture)
      sweep.timers    mega tier on a card: the phase timers reset, and
                      at a runner's first traced run its timed graph's
                      capture
      sweep.windows   the window loop and the final state's copy
        window          one a window: ``advance()`` and its sample's copy
      sweep.gather    with a mesh only
      sweep.collect   the copies to the host and the ``SweepResult``

While a profiler records, each span but ``window`` is also a
``record_function`` range of its name, so the profiler's trace names the
host work under each of its device gaps; a gap between two windows falls
in ``sweep.windows``.  (A range a window would cost the traced sweep a
``record_function`` a window, some microseconds of host time each.)

On the mega tier on a card the run's last window replays a graph of the
megakernel's timed instance (``kernels.fluid_step.phase_timers_on``)
between a CUDA event pair: the record gets that window's time
(``window_ms``), the step loop's nanoseconds (``mega_loop_ns``) and the
cycles between its marks (``mega_phases``).  Every other window replays
the untimed kernel, as an untraced run does.

Counters are always on, kept per thread (``count``, ``totals``); a
record holds what its run added (``COUNTERS``).  ``h2d_bytes`` and
``d2h_bytes`` count copies between the host and a card only, so they
read 0 on the CPU.

Finished records are kept in memory, the last ``KEEP`` of them
(``records()``, ``last()``).  The record being built is per thread:
several threads may run sweeps at once.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch

#: the counters a record holds: bytes copied host -> card, bytes of the
#: put cache's tensors reused without an upload (a put cache hit, or a
#: stage cache hit that holds them), bytes hashed for the content caches,
#: bytes copied card -> host, device bytes of a staged batch structure
#: that a stage cache hit reused (``experiments.STAGE_CACHE``)
COUNTERS = ("h2d_bytes", "put_hit_bytes", "digest_bytes", "d2h_bytes",
            "stage_hit_bytes")
#: finished records kept
KEEP = 16

_DONE: collections.deque = collections.deque(maxlen=KEEP)
_IDS = itertools.count(1)
_TLS = threading.local()
_FORCED = [0]                 # ``recording()`` blocks open, all threads
_FORCED_LOCK = threading.Lock()


def _totals() -> dict:
    try:
        return _TLS.totals
    except AttributeError:
        _TLS.totals = dict.fromkeys(COUNTERS, 0)
        return _TLS.totals


def count(name: str, n: int) -> None:
    """Add ``n`` to this thread's counter ``name``."""
    _totals()[name] += n


def totals() -> dict:
    """This thread's counters since it started."""
    return dict(_totals())


def nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def to_device(x: torch.Tensor, device) -> torch.Tensor:
    """``x.to(device)``, counted in ``h2d_bytes`` when it copies a host
    tensor to a card."""
    out = x.to(device)
    if out.device.type == "cuda" and x.device.type == "cpu":
        count("h2d_bytes", nbytes(x))
    return out


def to_host(x: torch.Tensor) -> torch.Tensor:
    """``x.detach().cpu()``, counted in ``d2h_bytes`` when ``x`` is on a
    card."""
    if x.device.type == "cuda":
        count("d2h_bytes", nbytes(x))
    return x.detach().cpu()


@contextlib.contextmanager
def recording():
    """``with recording():`` — every ``Sweep.run`` of the process that
    starts inside the block keeps a record, without a profiler."""
    with _FORCED_LOCK:
        _FORCED[0] += 1
    try:
        yield
    finally:
        with _FORCED_LOCK:
            _FORCED[0] -= 1


class Span:
    """One span: ``parent`` is the index of the enclosing span in its
    record's ``spans`` (-1 for the root)."""

    __slots__ = ("name", "parent", "start_ns", "end_ns")

    def __init__(self, name: str, parent: int, start_ns: int):
        self.name, self.parent = name, parent
        self.start_ns, self.end_ns = start_ns, None

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


class Record:
    """One ``Sweep.run``: its id, runs and tier, its spans, what it added
    to the counters and, on the mega tier on a card, its timed window."""

    def __init__(self, runs: int, device: torch.device, profiled: bool):
        self.sweep_id = next(_IDS)
        self.runs = runs
        self.device = str(device)
        self.tier = None
        self.timed = False        # the last window runs the timed kernel
        self.spans: list[Span] = []
        self.counters: dict = {}
        self.window_ms: list[float] = []
        self.mega_loop_ns = None
        self.mega_phases = None
        self.on_card = torch.device(device).type == "cuda"
        self._profiled = profiled
        self._open: list = []           # (span index, record_function)
        self._events = None
        self._start = totals()
        self._outer = current()         # a run this one is nested in

    # -- spans ---------------------------------------------------------------

    def enter(self, name: str, label: bool = True) -> None:
        rf = None
        if self._profiled and label:
            rf = torch.profiler.record_function(name)
            rf.__enter__()
        parent = self._open[-1][0] if self._open else -1
        self.spans.append(Span(name, parent, time.perf_counter_ns()))
        self._open.append((len(self.spans) - 1, rf))

    def exit(self) -> None:
        i, rf = self._open.pop()
        self.spans[i].end_ns = time.perf_counter_ns()
        if rf is not None:
            rf.__exit__(None, None, None)

    def window(self, runner, last: bool):
        """``runner.advance()`` as the start of a ``window`` span (the
        caller ``exit``s it once the sample is copied); the ``last`` of a
        timed run replays the runner's timed graph between a CUDA event
        pair."""
        self.enter("window", label=False)
        if not (last and self.timed):
            return runner.advance()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        runner.timed_next = True
        a.record()
        sample = runner.advance()
        b.record()
        self._events = (a, b)
        return sample

    def phases(self, timers: dict) -> None:
        """The megakernel's phase timers after the timed window
        (``kernels.fluid_step.read_phase_timers``, which waits for it)."""
        if timers["loops"] and self._events is not None:
            a, b = self._events
            self.window_ms = [a.elapsed_time(b)]
            self.mega_loop_ns = timers["loop_ns"]
            self.mega_phases = timers["phases"]
        self._events = None

    # -- reading -------------------------------------------------------------

    def named(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    @property
    def windows(self) -> int:
        """Trace windows the run ran."""
        return len(self.named("window"))

    def ms(self, name: str):
        """Milliseconds of the spans ``name`` together (None: no such
        span)."""
        spans = self.named(name)
        return sum(s.ns for s in spans) * 1e-6 if spans else None

    def _finish(self) -> None:
        while self._open:               # spans an exception left open
            self.exit()
        now = _totals()
        self.counters = {k: now[k] - self._start[k] for k in COUNTERS}


class _SpanCtx:
    __slots__ = ("rec", "name")

    def __init__(self, rec: Record, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.rec.enter(self.name)

    def __exit__(self, *exc):
        self.rec.exit()


#: the null span of a run that keeps no record
NULL = contextlib.nullcontext()


def span(rec: "Record | None", name: str):
    """``with span(rec, name):`` — a span of ``rec``, or nothing when the
    run keeps no record."""
    return NULL if rec is None else _SpanCtx(rec, name)


def current() -> "Record | None":
    """The record of the calling thread's ``Sweep.run`` (None: it keeps
    none)."""
    return getattr(_TLS, "rec", None)


def begin(runs: int, device) -> "Record | None":
    """Start the calling thread's record of a ``Sweep.run`` and its root
    span, when tracing is on (else None)."""
    profiled = torch._C._autograd._profiler_enabled()
    if not (profiled or _FORCED[0]):
        return None
    rec = Record(runs, device, profiled)
    _TLS.rec = rec
    rec.enter("sweep.run")
    return rec


def end(rec: "Record | None") -> None:
    """Close ``rec`` (from ``begin``) and keep it."""
    if rec is None:
        return
    try:
        rec._finish()
    finally:
        _TLS.rec, rec._outer = rec._outer, None
        _DONE.append(rec)


def records() -> list[Record]:
    """The kept records, oldest first."""
    return list(_DONE)


def last() -> "Record | None":
    """The newest kept record."""
    return _DONE[-1] if _DONE else None
