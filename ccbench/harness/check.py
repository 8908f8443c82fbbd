"""Whether a sweep of the window is correct: the program's ``SweepResult``
against the plain reference, run by run, on runs drawn from the seed.

Three numbers are compared, each with its limit (``LIMITS``):

* ``route_mismatch``: flows whose route, as the (source, sink) entities of
  its links, differs from the reference's minimal route (the scenario
  build); exact, limit 0.
* ``trace_gap``: the widest gap between the program and the reference,
  element by element over every decimated trace field and every
  final-state leaf of the checked runs, as a share of the reference's
  value (floored at a thousandth of the field's largest).
* ``summary_gap``: the widest relative gap over the runs' summaries
  (throughput, completion, queue peak, marks, notifications, fairness,
  slowdowns, pause time).

PERF.md gives the readings each limit was set from.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..reference import model as ref_model
from ..reference import scenario as ref_scenario
from ..reference.summary import summary as ref_summary

#: the limit of each compared number (PERF.md: the readings behind them)
LIMITS = {"route_mismatch": 0, "trace_gap": 0.05, "summary_gap": 0.05}

#: what a gap reads where one side is not finite (or the reference is
#: zero) and the other differs: more than any limit, and valid JSON
UNBOUNDED = 1e9

#: final-state leaves compared, by the reference's names (the program's
#: ``FluidState`` fields and ``cc`` entries of the same names)
FINAL_FIELDS = ("qh", "nicq", "delivered", "offered", "dropped", "est",
                "paused", "rate", "rp_target", "alpha", "byte_cnt", "tmr",
                "alpha_tmr", "bc_stage", "t_stage", "hold", "np_tmr",
                "trig_buf", "tgt_buf", "slope_acc", "swift_cool")


def pick_runs(cell, n: int, seed: int) -> list[int]:
    """``n`` runs drawn from the seed that together use every marking,
    notification and reaction stage of the grid, where ``n`` allows."""
    rng = np.random.default_rng([seed, 3])
    order = [int(i) for i in rng.permutation(cell.runs)]
    if n >= cell.runs:
        return sorted(order)
    stages = lambda r: {(k, s) for k, s in enumerate(cell.points[r][1])}  # noqa
    need = set().union(*(stages(r) for r in order))
    chosen = []
    while need and len(chosen) < n:
        best = max(order, key=lambda r: len(stages(r) & need))
        chosen.append(best)
        order.remove(best)
        need -= stages(best)
    chosen += order[:n - len(chosen)]
    return sorted(chosen)


def reference_result(cell, runs: list[int], scale: float, *,
                     dtype=torch.float32, device="cpu") -> dict:
    """The reference's traces, final state and summaries of ``runs`` at
    the parameter point ``scale``."""
    params = cell.params(scale)
    scns, stacks = [], []
    for r in runs:
        _, stack, roll, i = cell.points[r]
        scns.append(ref_scenario.build(cell.fabrics[roll],
                                       cell.scenes[roll][i], params["link"],
                                       cell.dt))
        stacks.append(stack)
    sp = ref_model.stage_params(params)
    batch = ref_model.Batch(scns, stacks, [sp] * len(runs), dt=cell.dt,
                            dtype=dtype, device=device)
    out = batch.run(cell.steps, cell.trace_every)
    T = out["traces"]["delivered"].shape[1]
    times = (np.arange(T) + 1) * cell.trace_every * cell.dt
    out["summaries"] = [
        ref_summary({f: v[j] for f, v in out["traces"].items()},
                    {k: out["final"][k][j] for k in ("delivered", "offered")},
                    scns[j], times=times,
                    line_rate=params["link"]["line_rate"])
        for j in range(len(runs))]
    out["scenarios"] = scns
    return out


def _gap(got, want) -> float:
    """The widest gap, element by element, as a share of the reference's
    magnitude there (floored at a thousandth of the field's largest, so
    an element near zero does not blow the ratio up)."""
    a = np.asarray(got, np.float64)
    b = np.asarray(want, np.float64)
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    if same.all():
        return 0.0
    if not (np.isfinite(a[~same]).all() and np.isfinite(b[~same]).all()):
        return UNBOUNDED
    floor = 1e-3 * np.abs(np.where(np.isfinite(b), b, 0.0)).max(initial=0.0)
    den = np.maximum(np.abs(b), floor)
    if (den[~same] == 0).any():
        return UNBOUNDED
    return float((np.abs(a - b)[~same] / den[~same]).max())


def _value_gap(got, want) -> float:
    if got is None or want is None:
        return 0.0 if got is want else UNBOUNDED
    a, b = float(got), float(want)
    if a == b or (math.isnan(a) and math.isnan(b)):
        return 0.0
    if not (math.isfinite(a) and math.isfinite(b)):
        return UNBOUNDED
    return abs(a - b) / abs(b) if b else UNBOUNDED


def program_view(res, runs: list[int], link_ends: dict, cell) -> dict:
    """What the program answered for ``runs``: traces, final state,
    summaries and routes (as entity paths of its own fabric)."""
    summ = res.summary()
    view = {"traces": {f: getattr(res.traces, f)[runs]
                       for f in ref_model.TRACE_FIELDS},
            "final": {k: np.stack([res.final.cc[k][r] if k in res.final.cc
                                   else getattr(res.final, k)[r]
                                   for r in runs]) for k in FINAL_FIELDS},
            "summaries": [summ[res.points[r].name] for r in runs],
            "routes": []}
    for r in runs:
        src, dst = link_ends[cell.points[r][2]]
        view["routes"].append([
            tuple((int(src[l]), int(dst[l])) for l in row if l != -1)
            for row in res.points[r].scenario.routes])
    return view


def reference_view(ref: dict, runs: list[int], cell) -> dict:
    view = {k: ref[k] for k in ("traces", "final", "summaries")}
    view["routes"] = [[cell.fabrics[cell.points[r][2]].entity_path(row)
                       for row in scn["routes"]]
                      for r, scn in zip(runs, ref["scenarios"])]
    return view


def compare(got: dict, want: dict) -> dict:
    """The compared numbers of one checked sweep: ``got`` (the program's
    view, or the control's) against ``want`` (the reference's)."""
    mismatch = sum(a != b for ra, rb in zip(got["routes"], want["routes"])
                   for a, b in zip(ra, rb))
    trace_gap = max([_gap(got["traces"][f], want["traces"][f])
                     for f in ref_model.TRACE_FIELDS]
                    + [_gap(got["final"][k], want["final"][k])
                       for k in FINAL_FIELDS])
    summary_gap = max(_value_gap(a.get(k), v)
                      for a, b in zip(got["summaries"], want["summaries"])
                      for k, v in b.items())
    return {"route_mismatch": int(mismatch), "trace_gap": trace_gap,
            "summary_gap": summary_gap}


def verdict(values: dict, limits: dict = LIMITS) -> bool:
    return all(values[k] <= limits[k] for k in limits)
