"""``autotune`` — the tuning front door — and Pareto-front utilities
(port of ``repro.tune.pareto``).

``autotune(cfg, scenario)`` replaces a hand-rolled ``config_grid``
sweep: pick a tuner (gradient on the soft model, ES or BO on the hard
one), run it, then **re-score every candidate on the exact hard model**
in one ``Sweep`` launch and return the winner.  The decision never
trusts the smoothed objective: a tuned config is reported as an
improvement only if its unsmoothed rollout beats the baseline's.

``pareto_autotune`` runs a scalarisation sweep (a weight grid over two
or more objectives), pools every hard-scored candidate and keeps the
non-dominated set — the goodput / tail-latency / overhead trade-off
curve the paper's single-number tables flatten.  Records serialise
through ``repro_torch.core.serialize`` (``TuneResult.to_record``) for the
``BENCH_tune.json`` benchmark trail.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.serialize import config_to_dict

from . import objectives
from .optimizers import (TUNERS, Evaluator, ParamBox, TuneProblem,
                         TuneTrace, _host_final, _TraceShim)

# ---------------------------------------------------------------------------
# Pareto fronts
# ---------------------------------------------------------------------------


def pareto_front(values: np.ndarray, senses=None) -> np.ndarray:
    """Indices of the non-dominated rows of ``values`` [N, M].

    ``senses`` ([M] of +/-1, default all +1) orients each column so
    that larger-after-scaling is better.  A point is kept iff no other
    point is >= in every objective and > in at least one.  Duplicate
    rows all survive (none strictly dominates its twin).
    """
    v = np.asarray(values, np.float64)
    if v.ndim != 2:
        raise ValueError(f"values must be [N, M], got shape {v.shape}")
    if senses is not None:
        v = v * np.asarray(senses, np.float64)[None, :]
    keep = []
    for i in range(v.shape[0]):
        ge = (v >= v[i]).all(axis=1)
        gt = (v > v[i]).any(axis=1)
        if not (ge & gt).any():
            keep.append(i)
    return np.asarray(keep, np.int64)


# ---------------------------------------------------------------------------
# hard re-scoring (the decision pass)
# ---------------------------------------------------------------------------


def _hard_eval(ev: Evaluator, thetas: np.ndarray):
    """One hard sweep over a theta batch -> (objective [P], metric
    dicts).  Metrics are the primitive objectives in natural units
    (p99 and ctrl unlogged) plus the host summary's aggregate Gbps."""
    from ..core.experiments import Sweep
    thetas = np.atleast_2d(np.asarray(thetas, np.float64))
    points = [(f"t{i}", ev.box.to_spec(ev.spec, th), ev.scn)
              for i, th in enumerate(thetas)]
    res = Sweep(points).run(n_steps=ev.problem.n_steps,
                            trace_every=ev.k, device=ev.device)
    vals, metrics = [], []
    for i in range(len(thetas)):
        r = res[i]
        vals.append(ev.hard_objective(r))
        shim = _TraceShim(r.ctrl)
        final = _host_final(r.final)
        raw = {name: float(fn(final, shim, ev.ctx_host))
               for name, fn in objectives.OBJECTIVES.items()}
        raw["p99_slowdown"] = float(np.exp(raw["p99_slowdown"]))
        raw["ctrl_overhead"] = float(np.expm1(raw["ctrl_overhead"]))
        raw["aggregate_gbps"] = float(
            r.mean_throughput_while_active().sum() / 1e9)
        metrics.append(raw)
    return np.asarray(vals), metrics


def _select_candidates(trace: TuneTrace, limit: int) -> np.ndarray:
    """Up to ``limit`` distinct thetas worth hard-scoring: the final
    iterate plus the tuner's top-valued visits."""
    order = np.argsort(trace.value)[::-1]
    picked = [len(trace.theta) - 1]            # always the final iterate
    for i in order:
        if len(picked) >= limit:
            break
        if not any(np.array_equal(trace.theta[i], trace.theta[j])
                   for j in picked):
            picked.append(int(i))
    return trace.theta[picked]


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TuneResult:
    """Outcome of one ``autotune`` call.

    ``improvement`` compares hard-model objectives (tuned minus
    baseline, higher-is-better scale); ``best_cfg`` is the winning
    frozen ``CCSpec`` (the *original* config when nothing beat it).
    """

    method: str
    objective: str                 # resolved signature string
    knobs: tuple                   # box knob names
    baseline_value: float
    best_value: float
    best_params: dict              # {knob: physical value}
    best_cfg: object               # CCSpec (or the input cfg if best)
    baseline_metrics: dict
    best_metrics: dict
    candidates: np.ndarray         # [P, d] hard-scored thetas
    candidate_values: np.ndarray   # [P]
    candidate_metrics: list
    trace: TuneTrace

    @property
    def improvement(self) -> float:
        return self.best_value - self.baseline_value

    @property
    def improved(self) -> bool:
        return self.best_value > self.baseline_value

    def to_record(self) -> dict:
        """JSON-ready benchmark record (``BENCH_tune.json`` row)."""
        return {
            "method": self.method,
            "objective": self.objective,
            "knobs": list(self.knobs),
            "baseline_value": float(self.baseline_value),
            "best_value": float(self.best_value),
            "improvement": float(self.improvement),
            "improved": bool(self.improved),
            "best_params": {k: float(v)
                            for k, v in self.best_params.items()},
            "best_cfg": config_to_dict(self.best_cfg),
            "baseline_metrics": self.baseline_metrics,
            "best_metrics": self.best_metrics,
            "n_evaluations": int(len(self.trace.value)),
        }


# ---------------------------------------------------------------------------
# front doors
# ---------------------------------------------------------------------------


def autotune(cfg, scenario, *, objective="default", method: str = "grad",
             box: ParamBox = None, n_steps: int = 2000,
             trace_every: int = 50, seed: int = 0,
             ckpt_dir: str = None, ckpt_every: int = 0,
             max_candidates: int = 16, device=None,
             **tuner_kw) -> TuneResult:
    """Tune ``cfg``'s CC constants for ``scenario`` and verify on the
    hard model.

    ``method`` picks the tuner (``"grad"`` / ``"es"`` / ``"bo"``);
    ``tuner_kw`` forwards to its constructor (e.g. ``iters=20``,
    ``temperature=0.05``).  ``ckpt_dir`` makes the tuner resumable
    through ``repro_torch.ckpt`` (bit-exact).  ``device=None`` runs on
    the card (pass ``device="cpu"`` to run on the CPU).  The returned
    :class:`TuneResult` carries the hard-verified winner — compare
    ``best_value`` against ``baseline_value`` (same objective, same
    unsmoothed model, scored in one batched sweep with the candidates).
    """
    if method not in TUNERS:
        raise KeyError(f"unknown method {method!r}; have {sorted(TUNERS)}")
    problem = TuneProblem(cfg, scenario, objective=objective, box=box,
                          n_steps=n_steps, trace_every=trace_every,
                          device=device)
    ev = Evaluator(problem)
    tuner = TUNERS[method](**tuner_kw)
    trace = tuner.run(ev, seed=seed, ckpt_dir=ckpt_dir,
                      ckpt_every=ckpt_every)

    theta0 = ev.box.encode(ev.spec)
    cand = np.vstack([theta0[None],
                      _select_candidates(trace, max_candidates)])
    values, metrics = _hard_eval(ev, cand)
    best = int(np.argmax(values))
    names = ev.box.names
    best_vals = ev.box.values(np.asarray(cand[best], np.float32), xp=np)
    return TuneResult(
        method=method, objective=ev.obj_sig, knobs=names,
        baseline_value=float(values[0]), best_value=float(values[best]),
        best_params=dict(zip(names, map(float, best_vals))),
        best_cfg=ev.spec if best == 0
        else ev.box.to_spec(ev.spec, cand[best]),
        baseline_metrics=metrics[0], best_metrics=metrics[best],
        candidates=cand, candidate_values=values,
        candidate_metrics=metrics, trace=trace)


def pareto_autotune(cfg, scenario, *, axes=("goodput", "p99_slowdown"),
                    n_weights: int = 5, method: str = "grad",
                    box: ParamBox = None, n_steps: int = 2000,
                    trace_every: int = 50, seed: int = 0, device=None,
                    **tuner_kw) -> dict:
    """Trade-off curve between two (or more) objectives.

    Runs ``autotune`` once per scalarisation weight (a geometric ramp
    of relative importances over ``axes``), pools every hard-scored
    candidate and returns the non-dominated set::

        {"axes": [...], "front": [{"weights": ..., "params": ...,
                                   "metrics": ...}, ...],
         "results": [TuneResult, ...]}

    The front is computed on the *hard* metric vectors, senses applied
    from ``objectives.SENSE`` — every point on it is a real,
    unsmoothed operating point of the model.
    """
    if len(axes) < 2:
        raise ValueError("pareto_autotune needs >= 2 objective axes")
    for a in axes:
        if a not in objectives.OBJECTIVES:
            raise KeyError(f"unknown objective axis {a!r}")
    ramps = np.linspace(0.0, 1.0, n_weights)
    results = []
    for w in ramps:
        # two-axis ramp; extra axes keep a small constant weight
        weights = {axes[0]: float(1.0 - w) + 1e-3,
                   axes[1]: float(w) + 1e-3}
        for a in axes[2:]:
            weights[a] = 0.05
        results.append(autotune(
            cfg, scenario, objective=weights, method=method, box=box,
            n_steps=n_steps, trace_every=trace_every, seed=seed,
            device=device, **tuner_kw))
    from .optimizers import box_for
    the_box = box if box is not None else box_for(cfg)
    pool_params, pool_metrics, pool_weights = [], [], []
    for res in results:
        for th, mets in zip(res.candidates, res.candidate_metrics):
            vals = the_box.values(np.asarray(th, np.float32), xp=np)
            pool_params.append(dict(zip(res.knobs, map(float, vals))))
            pool_metrics.append(mets)
            pool_weights.append(res.objective)
    mat = np.asarray([[m[a] for a in axes] for m in pool_metrics])
    # metrics are natural units here; log-senses still order the same
    senses = [objectives.SENSE[a] for a in axes]
    keep = pareto_front(mat, senses)
    front = [{"weights": pool_weights[i], "params": pool_params[i],
              "metrics": pool_metrics[i],
              "axis_values": [float(x) for x in mat[i]]}
             for i in keep]
    return {"axes": list(axes), "front": front, "results": results}
