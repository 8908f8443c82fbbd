"""Tuner objectives — scalar figures of merit in torch (port of
``repro.tune.objectives``).

Every objective is a torch function ``fn(final, trace, ctx) -> scalar``
over one finished rollout of one run: ``final`` holds the run's final
``delivered`` ([F]), ``trace`` its stacked ``ctrl`` ([T, F]) and ``ctx``
an :class:`ObjCtx` of scenario constants on the same device.  They run
where the rollout ran (on the card for the soft rollout's autograd, on
the host's CPU for the hard results' numpy), in float32, as the
reference's ``jnp`` versions do.

The four primitive metrics mirror the host-side ``SimResult`` methods
(``jain_index`` / ``p99_slowdown`` / ``ctrl_per_mb``) on the decimated
trace, with one deliberate simplification: per-flow mean rate is
``delivered / active-span`` instead of the host's completion-time
bookkeeping.  Gradient tuners differentiate these through the soft
rollout; the decisions are re-taken on the hard model.

  ==============  ======================================  =========
  name            objective value                         sense
  ==============  ======================================  =========
  goodput         delivered / offered capacity  [0, 1]    higher
  jain            Jain fairness index           [0, 1]    higher
  p99_slowdown    log(p99 flow slowdown)        [0, ~9]   lower
  ctrl_overhead   log1p(notifications per MB)   [0, ~7]   lower
  ==============  ======================================  =========

``resolve`` turns a name, a ``{name: weight}`` dict or a callable into
one higher-is-better scalar function (senses applied internally).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

_TINY = 1e-12


class ObjCtx(NamedTuple):
    """Scenario constants an objective needs beside the rollout."""

    gen_rate: torch.Tensor    # [F] f32 B/s offered
    t_start: torch.Tensor     # [F] f32 s
    t_stop: torch.Tensor      # [F] f32 s (inf = volume mode)
    line_rate: torch.Tensor   # [] f32 B/s
    horizon: torch.Tensor     # [] f32 s simulated
    dt: torch.Tensor          # [] f32 s


def make_ctx(scn, line_rate: float, horizon: float, dt: float, *,
             device="cpu") -> ObjCtx:
    """Build an :class:`ObjCtx` from a host scenario, on ``device``."""
    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)
    return ObjCtx(gen_rate=f32(scn.gen_rate), t_start=f32(scn.t_start),
                  t_stop=f32(scn.t_stop), line_rate=f32(line_rate),
                  horizon=f32(horizon), dt=f32(dt))


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


def _real(ctx: ObjCtx) -> torch.Tensor:
    """[F] f32 mask of flows with actual offered work (sweep padding
    rows carry zero rate)."""
    return (ctx.gen_rate > 0).to(torch.float32)


def _flow_rate(final, ctx: ObjCtx) -> torch.Tensor:
    """[F] mean delivery rate over each flow's active span (B/s)."""
    t1 = torch.minimum(ctx.t_stop, ctx.horizon)
    span = torch.maximum(t1 - ctx.t_start, ctx.dt)
    return final.delivered / span


# ---------------------------------------------------------------------------
# primitive metrics (natural sense; see SENSE below)
# ---------------------------------------------------------------------------


def goodput(final, trace, ctx: ObjCtx) -> torch.Tensor:
    """Delivered fraction of the offered (line-rate-capped) capacity."""
    m = _real(ctx)
    thr = _flow_rate(final, ctx)
    cap = torch.sum(m * torch.minimum(ctx.gen_rate, ctx.line_rate))
    return torch.sum(m * thr) / torch.clamp_min(cap, _TINY)


def jain(final, trace, ctx: ObjCtx) -> torch.Tensor:
    """Jain fairness over per-flow mean rates, in [1/n, 1]."""
    m = _real(ctx)
    x = m * _flow_rate(final, ctx)
    n = torch.sum(m)
    return torch.sum(x) ** 2 / torch.clamp_min(n * torch.sum(x * x), _TINY)


def p99_slowdown(final, trace, ctx: ObjCtx) -> torch.Tensor:
    """log of the ~p99 demand-normalised flow slowdown (lower better).

    Slowdown = min(offered, line) / achieved.  The p99 is the order
    statistic at rank ``ceil(0.01 * n_real)`` from the top of the real
    flows (non-real rows sort to the bottom at slowdown 1).
    """
    m = _real(ctx)
    thr = _flow_rate(final, ctx)
    ideal = torch.minimum(ctx.gen_rate, ctx.line_rate)
    s = ideal / torch.maximum(thr, 1e-6 * ctx.line_rate)
    s = torch.where(m > 0, s, 1.0)
    top = torch.sort(s, descending=True).values
    n = torch.sum(m)
    k = torch.clamp(torch.ceil(0.01 * n).to(torch.int64) - 1, 0,
                    s.shape[0] - 1)
    return torch.log(torch.clamp_min(top[k], 1.0))


def ctrl_overhead(final, trace, ctx: ObjCtx) -> torch.Tensor:
    """log1p of notification messages per delivered MB (lower better).

    ``trace.ctrl`` accumulates (possibly fractional, under the soft
    model) notification emissions per decimation window; the sum over
    the trace is the run total.
    """
    msgs = torch.sum(trace.ctrl)
    mb = torch.sum(final.delivered) / 1e6
    return torch.log1p(msgs / torch.clamp_min(mb, 1e-3))


OBJECTIVES: dict[str, Callable] = {
    "goodput": goodput,
    "jain": jain,
    "p99_slowdown": p99_slowdown,
    "ctrl_overhead": ctrl_overhead,
}

#: +1 = the metric is already higher-is-better; -1 = it is a cost.
SENSE = {"goodput": 1.0, "jain": 1.0,
         "p99_slowdown": -1.0, "ctrl_overhead": -1.0}

#: The default scalarisation ``autotune`` optimises: mostly goodput,
#: with fairness, tail and control-traffic regularisers.
DEFAULT_WEIGHTS = {"goodput": 1.0, "jain": 0.25,
                   "p99_slowdown": 0.15, "ctrl_overhead": 0.02}


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def weighted(weights: dict[str, float]) -> Callable:
    """Higher-is-better scalarisation ``sum_k w_k * sense_k * metric_k``
    (senses applied here; weights are positive importances)."""
    unknown = set(weights) - set(OBJECTIVES)
    if unknown:
        raise KeyError(f"unknown objective(s) {sorted(unknown)}; "
                       f"have {sorted(OBJECTIVES)}")

    def fn(final, trace, ctx):
        tot = _f32(0.0, ctx.gen_rate)
        for name, w in sorted(weights.items()):
            tot = tot + _f32(w * SENSE[name], tot) \
                * OBJECTIVES[name](final, trace, ctx)
        return tot

    return fn


def resolve(objective) -> tuple[Callable, str]:
    """(higher-is-better scalar fn, signature) from a name, a
    ``{name: weight}`` dict, ``"default"`` or a raw callable."""
    if callable(objective):
        sig = getattr(objective, "__name__", None) or repr(objective)
        return objective, f"callable:{sig}"
    if objective == "default":
        objective = DEFAULT_WEIGHTS
    if isinstance(objective, str):
        if objective not in OBJECTIVES:
            raise KeyError(f"unknown objective {objective!r}; "
                           f"have {sorted(OBJECTIVES)} or a weight dict")
        name = objective

        def fn(final, trace, ctx):
            return _f32(SENSE[name], ctx.gen_rate) \
                * OBJECTIVES[name](final, trace, ctx)
        return fn, f"name:{name}"
    if isinstance(objective, dict):
        sig = ",".join(f"{k}={float(v):g}"
                       for k, v in sorted(objective.items()))
        return weighted(objective), f"weighted:{sig}"
    raise TypeError(f"objective must be a name, weight dict or callable; "
                    f"got {type(objective).__name__}")
