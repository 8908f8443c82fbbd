"""CUDA-graph capture of code that launches the port's kernels.

Each kernel wrapper adds one to its module's ``LAUNCHES`` where it
launches its kernel.  A captured graph replays those kernels without
calling the wrappers, and the capture itself launches nothing, so
``CapturedGraph`` takes back what the capture added to every counter,
keeps it, and adds it again at each replay: the counters go on counting
the launches the card runs.

The caller warms ``fn`` up before the capture (a first eager call on a
side stream, as ``torch.cuda.graph`` requires), because only the caller
knows whether that call's result is real work or to be thrown away.
Capture errors (a host read, an unpinned host copy inside ``fn``) are
raised; there is no fallback to eager calls.

A capture runs in CUDA's global mode: while it lasts, an allocation or a
synchronising call from any other thread of the process invalidates it.
So every capture, and every device section of the port's runs that may
overlap one (``Sweep.run``, ``stream_sweep``, ``simulator.run``), holds
the card's lock (``card_lock``): on one card the device work of several
threads runs one section at a time, while their host work overlaps.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import threading
import time

import torch

_CARD_LOCKS: dict[int, threading.RLock] = {}
_CARD_LOCKS_GUARD = threading.Lock()


def card_lock(device):
    """The process-wide lock of ``device``'s card (reentrant, so a section
    may hold it around code that takes it again); a null context for a
    CPU device, whose work needs no such isolation."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return contextlib.nullcontext()
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    with _CARD_LOCKS_GUARD:
        return _CARD_LOCKS.setdefault(idx, threading.RLock())


def _counters() -> list[dict]:
    """Every kernel module's launch counters (the package binds the
    attention functions under the modules' names, so import by path)."""
    mods = {n: importlib.import_module(f"{__package__}.{n}") for n in (
        "cc_step", "fluid_reduce", "fluid_step", "flash_attention",
        "decode_attention")}
    return [m.LAUNCHES for m in mods.values()] + [
        mods["flash_attention"].ROUTES, mods["decode_attention"].PLANS]


class CapturedGraph:
    """``fn()`` captured once on the current device into a graph with
    its own memory pool; ``out`` is what that call returned (the graph's
    static outputs, rewritten by each ``replay()``).  ``launches`` holds
    each counter's launches a replay; ``capture_s`` the seconds the
    capture took.  ``release()`` frees the graph and its pool."""

    def __init__(self, fn):
        with card_lock(torch.device("cuda", torch.cuda.current_device())):
            self._capture(fn)

    def _capture(self, fn) -> None:
        counters = _counters()
        before = [dict(c) for c in counters]
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        # ``torch.cuda.graph`` without its ``empty_cache()`` on entry,
        # which would hand every cached block back to CUDA and
        # make the next eager calls (a serving engine's next prefill)
        # allocate them again
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        # the cyclic collector stays off while the capture lasts: a
        # finalizer it runs inside a global-mode capture (a dropped
        # engine's graph reset) invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(stream):
                graph.capture_begin()
                try:
                    out = fn()
                finally:
                    graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        torch.cuda.current_stream().wait_stream(stream)
        self.capture_s = time.perf_counter() - t0
        self.launches = []
        for c, b in zip(counters, before):
            self.launches.append({k: c[k] - b[k] for k in c if c[k] != b[k]})
            c.update(b)
        # the counters a replay adds to, resolved once
        self._adds = [(c, d) for c, d in zip(counters, self.launches) if d]
        self.graph, self.out = graph, out

    def replay(self) -> None:
        self.graph.replay()
        for c, d in self._adds:
            for k, n in d.items():
                c[k] += n

    def release(self) -> None:
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.out = None


def warm_up(fn):
    """``fn()`` once on a side stream (the warm-up ``torch.cuda.graph``
    asks for), finished before it returns, so its results are safe to
    use and free on the current stream; returns its result.  A later
    side stream waits for the current one before it allocates."""
    with card_lock(torch.device("cuda", torch.cuda.current_device())):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            out = fn()
        torch.cuda.synchronize()
    return out
