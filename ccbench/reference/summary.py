"""A run's headline numbers (one row of the paper's tables), in NumPy.

Given one run's decimated traces, its final delivered and offered bytes
and its scenario: throughput while active, completion, queue peak,
marks, notifications, fairness, slowdowns (the victims' among them) and
PFC pause time.
"""

from __future__ import annotations

import numpy as np


def summary(tr: dict, final: dict, scn: dict, *, times: np.ndarray,
            line_rate: float) -> dict:
    """``tr``: this run's trace fields ``[T, ...]``; ``final``: its
    ``delivered`` and ``offered`` ``[F]``; ``scn``: its scenario arrays."""
    inst = tr["inst_thr"]
    delivered = tr["delivered"]
    offered = np.asarray(final["offered"])
    vol = np.asarray(scn["volume"], np.float64)
    total = np.where(np.isfinite(vol), vol, offered)
    done = delivered >= 0.999 * np.maximum(total, 1e-300)[None, :]
    first = done.argmax(axis=0)
    hit = done.any(axis=0) & (total > 0)
    ct = np.where(hit, times[first], np.nan)
    completion = float(np.nanmax(ct)) if np.isfinite(ct).any() \
        else float("nan")
    t0 = np.asarray(scn["t_start"], np.float64)
    t1 = np.asarray(scn["t_stop"], np.float64)
    live = (times[:, None] >= t0[None, :]) & (times[:, None] < t1[None, :])
    n_live = live.sum(axis=0)
    mean_w = np.where(n_live > 0, (inst * live).sum(axis=0)
                      / np.maximum(n_live, 1), 0.0)
    span = ct - t0
    mean_v = np.where(np.isfinite(ct) & (span > 0),
                      delivered[-1] / np.maximum(span, 1e-300), 0.0)
    thr = np.where(np.isfinite(t1), mean_w, mean_v)
    real = np.asarray(scn["gen_rate"]) > 0
    thr_r = thr[real]
    if thr_r.size:
        denom = thr_r.size * float((thr_r ** 2).sum())
        jain = float(thr_r.sum()) ** 2 / denom if denom > 0 else 1.0
    else:
        jain = float("nan")
    ideal = np.minimum(np.asarray(scn["gen_rate"]), line_rate)[real]
    slow = ideal / np.maximum(thr_r, 1e-6 * line_rate)
    victim = np.asarray(scn["victim"], bool)[real]
    fin_sum = np.asarray(final["delivered"]).sum()
    mb = float(fin_sum) / 1e6
    return {
        "aggregate_gbps": float(thr.sum() / 1e9),
        "min_flow_gbps": float(thr.min() / 1e9),
        "completion_ms": completion * 1e3,
        "peak_queue_kb": float(tr["max_q"].max() / 1e3),
        "delivered_mb": float(fin_sum / 1e6),
        "marks": int(tr["marked"].sum()),
        "cnps": int(tr["cnp"].sum()),
        "jain_index": jain,
        "p99_slowdown": float(np.percentile(slow, 99)) if slow.size
        else float("nan"),
        "ctrl_per_mb": float(tr["ctrl"].sum()) / max(mb, 1e-9),
        "victim_slowdown": float(slow[victim].mean()) if victim.any()
        else float("nan"),
        "pause_s": float(np.asarray(tr["pause_time"]).sum()),
    }
