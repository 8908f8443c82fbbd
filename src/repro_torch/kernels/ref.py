"""Plain-torch oracles for the port's kernels (port of
``repro.kernels.ref``).

The CC functions are the straight-line definition of one dt of a
reaction point, elementwise over flows.  Parameters may be python floats
or tensors that broadcast against the ``[..., F]`` state (a Sweep passes
``[R, 1]`` columns, one value per run).  The attention functions are the
untiled definitions of ``flash_attention`` and ``decode_attention``,
including the reference's cast of the softmax weights to q's dtype
before the PV product.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# flash attention (train/prefill): causal / sliding-window / softcap
# ---------------------------------------------------------------------------

def attention_ref(q, k, v, *, causal: bool = True, window: int | None = None,
                  softcap: float = 0.0, scale: float | None = None):
    """q: [b, t, h, d]; k, v: [b, s, kv, d] (GQA) -> [b, t, h, d]."""
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, t, kv, h // kv, d)
    logits = torch.einsum("btkgd,bskd->bkgts", qg, k).float()
    logits = logits * scale
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    qpos = torch.arange(t, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((t, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", w, v)
    return out.reshape(b, t, h, d)


# ---------------------------------------------------------------------------
# decode attention: single query vs (possibly masked) KV cache
# ---------------------------------------------------------------------------

def decode_attention_ref(q, k, v, valid, *, softcap: float = 0.0,
                         scale: float | None = None):
    """q: [b, h, d]; k, v: [b, s, kv, d]; valid: [b, s] bool -> [b, h, d]."""
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, kv, h // kv, d)
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k).float()
    logits = logits * scale
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", w, v)
    return out.reshape(b, h, d)


# ---------------------------------------------------------------------------
# cc_step: the paper's reaction-point update at DC scale
# ---------------------------------------------------------------------------


class RPState(NamedTuple):
    rate: torch.Tensor        # [..., F] f32 B/s
    target: torch.Tensor
    alpha: torch.Tensor
    byte_cnt: torch.Tensor
    tmr: torch.Tensor
    alpha_tmr: torch.Tensor
    bc_stage: torch.Tensor    # f32, integral-valued
    t_stage: torch.Tensor


class RPParams(NamedTuple):
    g: object
    rate_decrease: object
    timer_T: object
    byte_B: object
    rai: object
    rhai: object
    fr_stages: object
    min_rate: object
    line_rate: object
    dt: object


class ERPParams(NamedTuple):
    settle: object
    hold: object
    min_rate: object
    line_rate: object
    dt: object


class SwiftKParams(NamedTuple):
    target: object             # s, queuing-delay target
    beta: object               # max multiplicative decrease
    ai: object                 # B/s^2 additive recovery slope
    guard: object              # s between decreases
    min_rate: object
    line_rate: object
    dt: object


def _clip(x, lo, hi):
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)`` with tensor bounds."""
    return torch.minimum(torch.maximum(x, _as(lo, x)), _as(hi, x))


def _as(v, like: torch.Tensor) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def rp_update_ref(st: RPState, cnp: torch.Tensor, p: RPParams) -> RPState:
    """One dt of the DCQCN RP state machine (``cnp`` is a bool mask)."""
    g = p.g
    alpha_tmr = st.alpha_tmr + p.dt
    a_tick = alpha_tmr >= p.timer_T
    alpha = torch.where(a_tick, (1 - g) * st.alpha, st.alpha)
    alpha_tmr = torch.where(a_tick, 0.0, alpha_tmr)

    target = torch.where(cnp, st.rate, st.target)
    rate = torch.where(cnp, st.rate * (1 - alpha * p.rate_decrease),
                       st.rate)
    alpha = torch.where(cnp, (1 - g) * alpha + g, alpha)
    byte_cnt = torch.where(cnp, 0.0, st.byte_cnt + st.rate * p.dt)
    tmr = torch.where(cnp, 0.0, st.tmr + p.dt)
    alpha_tmr = torch.where(cnp, 0.0, alpha_tmr)
    bc_stage = torch.where(cnp, 0.0, st.bc_stage)
    t_stage = torch.where(cnp, 0.0, st.t_stage)

    b_ev = byte_cnt >= p.byte_B
    t_ev = tmr >= p.timer_T
    byte_cnt = torch.where(b_ev, 0.0, byte_cnt)
    tmr = torch.where(t_ev, 0.0, tmr)
    bc_stage = bc_stage + b_ev.to(bc_stage.dtype)
    t_stage = t_stage + t_ev.to(t_stage.dtype)
    ev = b_ev | t_ev
    imax = torch.maximum(bc_stage, t_stage)
    imin = torch.minimum(bc_stage, t_stage)
    in_fr = imax <= p.fr_stages
    in_hyper = imin > p.fr_stages
    target = torch.where(ev & ~in_fr & ~in_hyper, target + p.rai, target)
    target = torch.where(ev & in_hyper,
                         target + p.rhai * (imin - p.fr_stages), target)
    rate = torch.where(ev, 0.5 * (rate + target), rate)
    rate = _clip(rate, p.min_rate, p.line_rate)
    target = _clip(target, p.min_rate, p.line_rate)
    return RPState(rate, target, alpha, byte_cnt, tmr, alpha_tmr,
                   bc_stage, t_stage)


def erp_update_ref(rate, hold, cnp, tgt_rx, slope, p: ERPParams):
    """One dt of the paper's ERP: jump to the signalled fair share, hold,
    desynchronised additive recovery (``cnp`` is a bool mask)."""
    rate = torch.where(cnp, torch.maximum(p.settle * tgt_rx,
                                          _as(p.min_rate, rate)), rate)
    hold = torch.where(cnp, _as(p.hold, hold),
                       torch.clamp_min(hold - p.dt, 0.0))
    rate = torch.where(~cnp & (hold <= 0), rate + slope * p.dt, rate)
    rate = _clip(rate, p.min_rate, p.line_rate)
    return rate, hold


def swift_update_ref(rate, cool, qdelay, *, target, beta, ai, guard,
                     min_rate, line_rate, dt):
    """One dt of the delay-target reaction (Swift-like): multiplicative
    decrease in proportion to the delay excess over ``target``, bounded
    by ``beta`` and paced by the ``guard`` cool-down; additive recovery
    below target."""
    cool = torch.clamp_min(cool - dt, 0.0)
    over = qdelay > target
    can = cool <= 0.0
    factor = 1.0 - beta * (qdelay - target) / torch.clamp_min(qdelay,
                                                               1e-12)
    dec = torch.maximum(rate * torch.maximum(factor, _as(1.0 - beta, rate)),
                        _as(min_rate, rate))
    rate = torch.where(over & can, dec,
                       torch.where(over, rate, rate + ai * dt))
    cool = torch.where(over & can, _as(guard, cool), cool)
    rate = _clip(rate, min_rate, line_rate)
    return rate, cool
