"""The traced window: one sweep of the cell under ``torch.profiler`` with
CUDA events around each trace window the program replays, reduced to the
record the per-layer readers read.

The program's host phases, ``Sweep._prepare`` and ``Sweep.collect``, run
under profiler labels of those names, so the idle gaps name them.  Device
busy time is the union of the kernels' intervals in the profiler's
trace; where it sees less than half of what the windows' CUDA-event spans
hold (it misses the megakernel inside a replayed graph), the spans stand
in for it.  Idle
gaps between kernels are labelled by the innermost host operation running
at the gap's middle.
"""

from __future__ import annotations

import bisect
import time

#: profiler labels of the program's host phases (their device-side
#: annotation spans are not device work)
LABELS = ("Sweep._prepare", "Sweep.collect")


def _union_s(intervals) -> float:
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy * 1e-6


def _gaps(kernels, cpu_events, top: int = 10):
    """The longest idle gaps between device kernels, summed by the host
    operation that was running in each (seconds)."""
    ks = sorted(kernels)
    gaps, end = [], None
    for a, b in ks:
        if end is not None and a > end:
            gaps.append((a - end, end, a))
        end = b if end is None else max(end, b)
    gaps.sort(reverse=True)
    gaps = gaps[:500]
    starts = [e[0] for e in cpu_events]
    by_name: dict = {}
    for length, a, b in gaps:
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid)
        best = None
        for j in range(i - 1, max(-1, i - 400), -1):
            s, e, name = cpu_events[j]
            if s <= mid <= e and (best is None or e - s < best[0]):
                best = (e - s, name)
        name = best[1] if best else "no host operation"
        by_name[name] = by_name.get(name, 0.0) + length * 1e-6
    return sorted(([k, v] for k, v in by_name.items()),
                  key=lambda kv: -kv[1])[:top]


def traced_sweep(sweep, run_kw: dict, on_card: bool = True) -> dict:
    """Run ``sweep`` once, traced; returns kernels by name, busy and wall
    seconds, per-window event spans and the idle gaps (``on_card``
    False: the CPU, where no event is recorded and nothing is busy on a
    device)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.core import experiments

    spans = []
    advance = experiments.WindowExecutable.advance

    def timed(self):
        if not on_card:
            return advance(self)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = advance(self)
        b.record()
        spans.append((a, b))
        return out

    def labelled(name, fn):
        def run(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return run

    Sweep = experiments.Sweep
    prepare, collect = Sweep._prepare, Sweep.collect
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()
    experiments.WindowExecutable.advance = timed
    Sweep._prepare = labelled(LABELS[0], prepare)
    Sweep.collect = labelled(LABELS[1], collect)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sweep.run(**run_kw)
            sync()
            wall = time.perf_counter() - t0
    finally:
        experiments.WindowExecutable.advance = advance
        Sweep._prepare, Sweep.collect = prepare, collect
    window_ms = [a.elapsed_time(b) for a, b in spans]
    kernels, cpu, by_name = [], [], {}
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA and e.name not in LABELS \
                and not getattr(e, "is_user_annotation", False):
            kernels.append((tr.start, tr.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                tr.elapsed_us() * 1e-6
        else:
            cpu.append((tr.start, tr.end, e.name))
    cpu.sort()
    rec = {"wall_s": wall, "window_ms": window_ms, "n_kernels": len(kernels),
           "kernel_s": by_name}
    prof_busy = _union_s(kernels) if kernels else 0.0
    span_busy = sum(window_ms) * 1e-3
    if prof_busy >= 0.5 * span_busy and kernels:
        rec.update(busy_s=prof_busy, timed_by="profiler",
                   idle_gaps=_gaps(kernels, cpu))
    else:                     # the profiler missed the replayed windows
        rec.update(busy_s=span_busy, timed_by="cuda events",
                   idle_gaps=[["host between windows",
                               max(0.0, wall - span_busy)]])
    return rec
