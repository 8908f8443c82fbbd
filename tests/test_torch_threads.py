"""Several threads running the port's Sweep at once, on the CPU.

A cached sweep window (``experiments.WindowExecutable``) owns the tensors
of the batch it runs, so two runs of one batch structure must not use it
at the same time, and the cache must not free it under a run.  The
reference's executable is a pure function, so there the same concurrent
use is safe (its fleet runs ``ThreadBackend`` on it, ``tests/test_fleet.py``).

  * a runner resolved for sweep A keeps A's batch when a runner for B,
    of the same structure, is resolved before A's windows run; a nested
    run of one structure in one thread is refused;
  * three sweeps of one structure run from three threads (switching
    threads every 10 us) give the bits each gives alone, and the cache
    builds their entry once;
  * with a cache of capacity 1, a run whose entry is evicted while it
    runs (by the same thread, and by another thread) still gives its
    bits; the entry is freed when the run lets it go.
"""

import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)      # tiny tensors: threads only add overhead

from repro_torch.core import (CCScheme, PAPER_CONFIG,        # noqa: E402
                              SWEEP_EXEC_CACHE, ScenarioSpec, Sweep)
from repro_torch.core.experiments import _sweep_executable   # noqa: E402
from repro_torch.core.simulator import (TraceSample,           # noqa: E402
                                        decimating_scan)

N_STEPS, TRACE = 300, 50
KW = dict(reduce="fused", use_kernels=False, pad_runs_to=None,
          min_delay_slots=None, dense_rows=None, temperature=0.0,
          min_switches=None, mesh=None, device="cpu")


def _sweep(scheme: CCScheme) -> Sweep:
    """One point: ``scheme`` on the paper's incast, flows open at 0."""
    return Sweep([("p", PAPER_CONFIG.replace(scheme=scheme),
                   ScenarioSpec.paper_incast(roll=0, t_start=0.0))])


def _other() -> Sweep:
    """A sweep of another batch structure (two points)."""
    spec = ScenarioSpec.paper_incast(roll=0, t_start=0.0)
    return Sweep([(s.name, PAPER_CONFIG.replace(scheme=s), spec)
                  for s in (CCScheme.DCQCN, CCScheme.PFC_ONLY)])


def _leaves(res):
    for f in res.traces._fields:
        yield f"traces.{f}", np.asarray(getattr(res.traces, f))
    for f in res.final._fields:
        x = getattr(res.final, f)
        for k, v in (x.items() if isinstance(x, dict) else [("", x)]):
            yield f"final.{f}{k}", np.asarray(v)


def _bitwise(a, b) -> bool:
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [n for n, _ in la] == [n for n, _ in lb]
    return all(np.array_equal(x, y, equal_nan=True)
               for (_, x), (_, y) in zip(la, lb))


def _run(sweep, device="cpu", **kw):
    return sweep.run(N_STEPS, TRACE, device=device, **kw)


@pytest.fixture(scope="module")
def serial():
    """Each scheme's sweep and its result, run one after another."""
    SWEEP_EXEC_CACHE.clear()
    sweeps = {s: _sweep(s) for s in CCScheme}
    out = {s: (sw, _run(sw)) for s, sw in sweeps.items()}
    res = [r for _, r in out.values()]
    # the points differ, so a run that took another's batch would show
    assert not any(_bitwise(a, b) for i, a in enumerate(res)
                   for b in res[i + 1:])
    return out


def _threads(work, n: int) -> list:
    """Run ``work(i)`` in ``n`` threads started together, switching
    threads every 10 us; returns the errors they raised."""
    errors, barrier = [], threading.Barrier(n)

    def body(i):
        try:
            barrier.wait()
            work(i)
        except BaseException as e:       # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=body, args=(i,)) for i in range(n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=600)
        assert not any(t.is_alive() for t in ts), "a thread hung"
    finally:
        sys.setswitchinterval(old)
    return errors


def test_a_resolved_runner_keeps_its_batch(serial):
    a, want_a = serial[CCScheme.DCQCN]
    b, want_b = serial[CCScheme.DCQCN_REV]
    sa, ia, n = a._prepare(N_STEPS, TRACE, **KW)
    sb, ib, _ = b._prepare(N_STEPS, TRACE, **KW)
    run_a = _sweep_executable(sa, ia)
    run_b = _sweep_executable(sb, ib)      # resolved, not run
    with run_a as runner:
        final, tr = decimating_scan(None, ia.state, n, sa.trace_every,
                                    sa.dt, a.n_vcs, runner=runner)
    assert _bitwise(a.collect(final, tr, sa.trace_every), want_a)
    # a nested run of one structure in one thread is refused
    with run_b:
        with pytest.raises(RuntimeError, match="nested"):
            with _sweep_executable(sa, ia):
                pass
    assert _bitwise(_run(b), want_b)


def test_threads_get_their_serial_bits(serial):
    schemes = list(serial)
    s0 = SWEEP_EXEC_CACHE.stats()
    got = {s: [] for s in schemes}

    def work(i):
        s = schemes[i]
        for _ in range(2):
            got[s].append(_run(serial[s][0]))

    assert _threads(work, len(schemes)) == []
    for s in schemes:
        assert len(got[s]) == 2
        for res in got[s]:
            assert _bitwise(res, serial[s][1]), s.name
    d = SWEEP_EXEC_CACHE.stats() - s0
    assert (d.misses, d.hits) == (0, 2 * len(schemes))   # one structure


def test_eviction_waits_for_the_run(serial):
    a, want_a = serial[CCScheme.DCQCN]
    other = _other()
    want_o = _run(other)
    cap = SWEEP_EXEC_CACHE.capacity
    SWEEP_EXEC_CACHE.resize(1)
    try:
        # the same thread evicts the entry it is running
        sa, ia, n = a._prepare(N_STEPS, TRACE, **KW)
        samples = []
        with _sweep_executable(sa, ia) as runner:
            runner.start(ia.state)
            for i in range(n):
                samples.append([x.clone() for x in runner.advance()])
                if i == 1:
                    assert _bitwise(_run(other), want_o)   # evicts a's
                    assert runner.inputs is not None       # not yet freed
            final = runner.state
            final = type(final)(*[x.clone() for x in final[:-2]],
                                cc={k: v.clone()
                                    for k, v in final.cc.items()},
                                t=final.t.clone())
        assert runner.inputs is None                       # freed now
        tr = TraceSample(*[torch.stack(f) for f in zip(*samples)])
        got = a.collect(final, tr, sa.trace_every)
        assert _bitwise(got, want_a)

        # two threads evicting each other's entries while they run
        results = {0: [], 1: []}
        sweeps = (a, other)

        def work(i):
            for _ in range(3):
                results[i].append(_run(sweeps[i]))

        s0 = SWEEP_EXEC_CACHE.stats()
        assert _threads(work, 2) == []
        assert all(_bitwise(r, want_a) for r in results[0])
        assert all(_bitwise(r, want_o) for r in results[1])
        d = SWEEP_EXEC_CACHE.stats() - s0
        # a run that finds its entry released before it could take it
        # looks it up again, so lookups may exceed the 6 runs
        assert d.lookups >= 6 and d.evictions >= 1, d
    finally:
        SWEEP_EXEC_CACHE.resize(cap)


@pytest.mark.cuda
def test_threads_capture_and_replay_on_cuda(serial):
    """On a card: threads running sweeps of two structures on two tiers,
    each first run a capture while the others replay, get their serial
    bits — no capture is invalidated by another thread's work."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU form)")
    dev = torch.device("cuda", torch.cuda.current_device())
    jobs = [(serial[s][0], kw) for s in CCScheme
            for kw in ({}, {"use_kernels": "mega"})] + [(_other(), {})]
    SWEEP_EXEC_CACHE.clear()
    want = [_run(sw, dev, **kw) for sw, kw in jobs]
    SWEEP_EXEC_CACHE.clear()
    got = {i: [] for i in range(len(jobs))}

    def work(i):
        sw, kw = jobs[i]
        for _ in range(2):
            got[i].append(_run(sw, dev, **kw))

    assert _threads(work, len(jobs)) == []
    for i, w in enumerate(want):
        assert all(_bitwise(r, w) for r in got[i]), jobs[i][1]
    SWEEP_EXEC_CACHE.clear()

