"""Composable CC-stage registry (port of ``repro.core.cc``).

Three families — **marking**, **notification**, **reaction** — are
registries of small components; a ``CCSpec(marking=..., notification=...,
reaction=...)`` names one entry per family.  Codes follow registration
order and the built-in order is frozen (cp/ecp/slope, np/enp/fncc,
pfc/rp/erp/swift), so they match the reference's codes.

Every stage works on the port's batched layout: contexts are
``[R, F]`` / ``[R, F, H]`` tensors with a leading run axis, and each
family's params are a dict of ``[R]`` tensors (one value per run).
``dispatch`` evaluates every registered stage and selects per run by
the family code, so one step serves any mix of stage combinations.

Soft relaxation (``repro_torch.tune``): every context carries ``tau``,
the per-run temperature ``[R]`` of a soft batch, or ``None`` in a hard
one.  ``None`` builds exactly the hard stage; with a tensor every
softened site is ``soft.select(tau, soft_expr, hard_expr)`` with the
hard code verbatim as ``hard_expr``, so a run at tau = 0 takes the hard
value bitwise.  Whether a batch is soft is static (the caller decides
once), never a branch on the temperature's value.

The reaction stages ``rp``, ``erp`` and ``swift`` run through the
per-flow wrappers of ``repro_torch.kernels.cc_step``: on a CUDA tensor
they launch the Hopper kernels, on a CPU tensor the plain versions.
In a soft batch the kernel's result is the stage's ``hard_expr`` and a
torch transcription of the reference's soft update the ``soft_expr``;
under autograd the wrappers differentiate the kernels through their
plain versions (``kernels.cc_step``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..kernels import cc_step
from ..kernels.ref import ERPParams, RPParams, RPState, SwiftKParams
from ..tune import soft


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Stage:
    """One registered component of a family."""

    family: str
    name: str
    code: int
    params: dict                      # {field: (spec) -> python scalar}
    step: Callable                    # (params, ctx, state, packed) -> (out, upd)
    int_params: frozenset = frozenset()   # fields held as int32
    init_state: Callable | None = None
    # reaction stages only: does this stage read the mark/CNP feedback?
    consumes_marks: bool = True


class StageRegistry:
    """Ordered name -> Stage mapping; codes follow registration order."""

    def __init__(self, family: str):
        self.family = family
        self._stages: dict[str, Stage] = {}

    def register(self, name: str, *, step: Callable,
                 params: dict | None = None, int_params: tuple = (),
                 init_state: Callable | None = None,
                 consumes_marks: bool = True) -> Stage:
        if name in self._stages:
            raise ValueError(
                f"{self.family} stage {name!r} already registered")
        stage = Stage(family=self.family, name=name,
                      code=len(self._stages), params=dict(params or {}),
                      int_params=frozenset(int_params), step=step,
                      init_state=init_state, consumes_marks=consumes_marks)
        self._stages[name] = stage
        return stage

    def __contains__(self, name: str) -> bool:
        return name in self._stages

    def names(self) -> tuple[str, ...]:
        return tuple(self._stages)

    def get(self, name: str) -> Stage:
        if name not in self._stages:
            raise KeyError(
                f"unknown {self.family} stage {name!r}; registered: "
                f"{self.names()}")
        return self._stages[name]

    def code(self, name: str) -> int:
        return self.get(name).code

    def stages(self) -> tuple[Stage, ...]:
        return tuple(self._stages.values())

    def device_params(self, spec) -> dict:
        """Union of every registered stage's param scalars as 0-d
        tensors (float32, or int32 for ``int_params``).  A field name
        declared by several stages must extract the same value."""
        out: dict = {}
        for stage in self.stages():
            for field, fn in stage.params.items():
                v = fn(spec)
                is_int = field in stage.int_params
                if field in out:
                    if out[field] != (v, is_int):
                        raise ValueError(
                            f"{self.family} param {field!r} extracted "
                            f"conflicting values {out[field][0]!r} vs "
                            f"{v!r}; shared field names must share "
                            f"semantics — namespace stage-specific "
                            f"params by the stage name")
                    continue
                out[field] = (v, is_int)
        return {field: torch.tensor(v, dtype=torch.int32 if is_int
                                    else torch.float32)
                for field, (v, is_int) in out.items()}

    def init_cc_state(self, scn) -> dict:
        """Every registered stage's per-flow state (numpy) for one
        scenario."""
        out: dict = {}
        for stage in self.stages():
            if stage.init_state is None:
                continue
            for k, v in stage.init_state(scn).items():
                if k in out:
                    raise ValueError(
                        f"{self.family} state key {k!r} declared twice; "
                        f"namespace state keys by the stage name")
                out[k] = np.asarray(v)
        return out


MARKING = StageRegistry("marking")
NOTIFICATION = StageRegistry("notification")
REACTION = StageRegistry("reaction")

FAMILIES = (MARKING, NOTIFICATION, REACTION)


def init_cc_state(scn) -> dict:
    """Union of all families' per-flow stage state (numpy) for one
    scenario."""
    out: dict = {}
    for reg in FAMILIES:
        for k, v in reg.init_cc_state(scn).items():
            if k in out:
                raise ValueError(f"cc state key {k!r} declared by two "
                                 f"families")
            out[k] = v
    return out


def _tree_select(cond_fn, a, b):
    """Leafwise ``where(cond, b, a)`` over tensors, tuples and dicts."""
    if isinstance(a, torch.Tensor):
        return torch.where(cond_fn(a.dim()), b, a)
    if isinstance(a, dict):
        return {k: _tree_select(cond_fn, a[k], b[k]) for k in a}
    vals = [_tree_select(cond_fn, x, y) for x, y in zip(a, b)]
    return type(a)(*vals) if hasattr(a, "_fields") else type(a)(vals)


def _select(code: torch.Tensor, outs):
    """Per-run where-chain over same-structure ``(stage code, output)``
    pairs, the first as the base (``code`` is [R]; each leaf has a
    leading run axis)."""
    sel = outs[0][1]
    for i, o in outs[1:]:
        hit = code == i
        sel = _tree_select(
            lambda nd, hit=hit: hit.reshape((-1,) + (1,) * (nd - 1)),
            sel, o)
    return sel


def dispatch(registry: StageRegistry, code, params: dict, ctx,
             state: dict, *, packed: dict | None = None,
             only: frozenset | None = None):
    """Evaluate every stage of ``registry`` and select per run by code.

    Returns ``(outputs, family_state)``: ``family_state`` maps every
    state key a stage of this family owns to its post-step value
    (unselected stages pass theirs through).  ``packed`` maps stage
    names to prepacked kernel parameter rows (``pack_react_rows``).
    ``only`` (a set of codes that covers every run's ``code``) evaluates
    just those stages: the same selected values, fewer ops.
    """
    outs = []
    owned: set[str] = set()
    for stage in registry.stages():
        if only is not None and stage.code not in only:
            continue
        pk = None if packed is None else packed.get(stage.name)
        main, upd = stage.step(params, ctx, state, pk)
        owned.update(upd)
        outs.append((stage.code, main, upd))
    full = []
    for i, main, upd in outs:
        merged = {k: state[k] for k in owned}
        merged.update(upd)
        full.append((i, (main, merged)))
    return _select(code, full)


def pack_react_rows(react: dict, line_rate, dt) -> dict:
    """Per-run kernel parameter rows ``[R, NP]`` of the built-in
    reaction stages, packed once per launch (pure functions of each
    run's constants); row layouts live in ``kernels.cc_step``."""
    return {"rp": cc_step.pack_rp_params(_rp_params(react, line_rate, dt)),
            "erp": cc_step.pack_erp_params(
                _erp_params(react, line_rate, dt)),
            "swift": cc_step.pack_swift_params(
                _swift_params(react, line_rate, dt))}


def _rp_params(p, line_rate, dt) -> RPParams:
    return RPParams(g=p["rp_g"], rate_decrease=p["rp_rdf"],
                    timer_T=p["rp_timer"], byte_B=p["rp_byte"],
                    rai=p["rp_rai"], rhai=p["rp_rhai"],
                    fr_stages=p["rp_fr_stages"].to(torch.float32),
                    min_rate=p["rp_min_rate"], line_rate=line_rate, dt=dt)


def _erp_params(p, line_rate, dt) -> ERPParams:
    return ERPParams(settle=p["erp_settle"], hold=p["erp_hold"],
                     min_rate=p["erp_min_rate"], line_rate=line_rate,
                     dt=dt)


def _swift_params(p, line_rate, dt) -> SwiftKParams:
    return SwiftKParams(target=p["swift_target"], beta=p["swift_beta"],
                        ai=p["swift_ai"], guard=p["swift_guard"],
                        min_rate=p["swift_min_rate"], line_rate=line_rate,
                        dt=dt)


# ---------------------------------------------------------------------------
# family contexts (leading run axis R everywhere)
# ---------------------------------------------------------------------------


class MarkCtx(NamedTuple):
    """Phase-4 context: per-(run, flow, hop) congestion signals."""

    B1_w: torch.Tensor        # [R, F, H] f32 occupancy of the hop's queue
    present: torch.Tensor     # [R, F, H] bool
    holds_queue: torch.Tensor  # [R, F, H] bool
    dem_next: torch.Tensor    # [R, F, H] f32
    grant_next: torch.Tensor  # [R, F, H] f32
    over_next: torch.Tensor   # [R, F, H] f32 (exact 0/1 hard)
    port_buffer: torch.Tensor  # [R] f32
    line_rate: torch.Tensor   # [R] f32
    tau: torch.Tensor | None = None   # [R] f32 in a soft batch


class NotifCtx(NamedTuple):
    """Phase-5 context: who marked, and the delay-line geometry."""

    marked: torch.Tensor      # [R, F] f32 mark level (exact 0/1 hard)
    mark_fh: torch.Tensor     # [R, F, H] f32
    np_tmr_t: torch.Tensor    # [R, F] f32 suppression timer (post-tick)
    hops: torch.Tensor        # [R, F] int current path's hop count
    rtt: torch.Tensor         # [R, F] int end-to-end delay in dt steps
    t: torch.Tensor           # [R] int32 step counter
    D: int                    # static delay-line depth
    tau: torch.Tensor | None = None   # [R] f32 in a soft batch


class ReactCtx(NamedTuple):
    """Phase-6 context: reaction-point state + feedback signals."""

    rate: torch.Tensor        # [R, F] f32
    rp_target: torch.Tensor
    alpha: torch.Tensor
    byte_cnt: torch.Tensor
    tmr: torch.Tensor
    alpha_tmr: torch.Tensor
    bc_stage: torch.Tensor    # [R, F] int32
    t_stage: torch.Tensor     # [R, F] int32
    hold: torch.Tensor
    cnp: torch.Tensor         # [R, F] f32 notification level (0/1 hard)
    tgt_rx: torch.Tensor      # [R, F] f32 received severity payload
    qdelay: torch.Tensor      # [R, F] f32 queuing-delay estimate (s)
    jitter: torch.Tensor      # [R, F] f32 deterministic per-flow jitter
    gen_rate: torch.Tensor    # [R, F] f32 offered rate (pfc source)
    line_rate: torch.Tensor   # [R] f32
    dt: torch.Tensor          # [] f32
    tau: torch.Tensor | None = None   # [R] f32 in a soft batch


class ReactOut(NamedTuple):
    """Reaction-point state after one dt (fields a stage does not own
    pass through from the context)."""

    rate: torch.Tensor
    rp_target: torch.Tensor
    alpha: torch.Tensor
    byte_cnt: torch.Tensor
    tmr: torch.Tensor
    alpha_tmr: torch.Tensor
    bc_stage: torch.Tensor
    t_stage: torch.Tensor
    hold: torch.Tensor


def _passthrough(ctx: ReactCtx) -> ReactOut:
    return ReactOut(rate=ctx.rate, rp_target=ctx.rp_target,
                    alpha=ctx.alpha, byte_cnt=ctx.byte_cnt, tmr=ctx.tmr,
                    alpha_tmr=ctx.alpha_tmr, bc_stage=ctx.bc_stage,
                    t_stage=ctx.t_stage, hold=ctx.hold)


def _c2(x: torch.Tensor) -> torch.Tensor:
    """[R] -> [R, 1]: a per-run constant against [R, F]."""
    return x[:, None]


def _c3(x: torch.Tensor) -> torch.Tensor:
    """[R] -> [R, 1, 1]: a per-run constant against [R, F, H]."""
    return x[:, None, None]


# ---------------------------------------------------------------------------
# marking stages
# ---------------------------------------------------------------------------


def _mark_common(thresh, ctx: MarkCtx):
    """(base mark intensity, queue excess over thresh in [0, 1]).

    The intensity is an exact 0/1 float in hard mode; under the soft
    model the threshold crossing becomes a sigmoid in the occupancy (the
    site that gives kmin / the detection threshold a gradient).  The
    presence gates stay hard multipliers.
    """
    base = ((ctx.B1_w > thresh) & ctx.present
            & ctx.holds_queue).to(torch.float32)
    if ctx.tau is not None:
        tau = _c3(ctx.tau)
        gate_s = (soft.unit_gate(ctx.B1_w - thresh, tau,
                                 _c3(ctx.port_buffer))
                  * ctx.present * ctx.holds_queue)
        base = soft.select(tau, gate_s, base)
    qexc = torch.clamp((ctx.B1_w - thresh) / _c3(ctx.port_buffer),
                       0.0, 1.0)
    return base, qexc


def _severity(ctx: MarkCtx, drain_gain, qexc):
    """``grant_next * (1 - drain_gain * qexc)``; inf grants stay inf
    (never on a product, so no infinite partial reaches autograd)."""
    finite = torch.isfinite(ctx.grant_next)
    g_fin = torch.where(finite, ctx.grant_next, 0.0)
    return torch.where(finite, g_fin * (1.0 - drain_gain * qexc),
                       torch.inf)


def _mark_cp(p, ctx: MarkCtx, state, packed=None):
    base, qexc = _mark_common(_c3(p["cp_kmin"]), ctx)
    sev = _severity(ctx, _c3(p["drain_gain"]), qexc)
    return (base, sev), {}


def _mark_ecp(p, ctx: MarkCtx, state, packed=None):
    base, qexc = _mark_common(_c3(p["ecp_thresh"]), ctx)
    congesting = ((ctx.over_next > 0)
                  & (ctx.dem_next > _c3(p["ecp_slack"]) * ctx.grant_next)
                  ).to(torch.float32)
    if ctx.tau is not None:
        # graded oversubscription x a sigmoid in the demand excess
        # (grant_next's inf sentinels drive it to exactly 0, never nan)
        tau = _c3(ctx.tau)
        cong_s = ctx.over_next * soft.unit_gate(
            ctx.dem_next - _c3(p["ecp_slack"]) * ctx.grant_next, tau,
            _c3(ctx.line_rate))
        congesting = soft.select(tau, cong_s, congesting)
    sev = _severity(ctx, _c3(p["drain_gain"]), qexc)
    return (base * congesting, sev), {}


def _mark_slope(p, ctx: MarkCtx, state, packed=None):
    """RED-style kmin..kmax ramp, realised by per-flow error diffusion
    (an accumulator fires a mark when it crosses 1 and spends it; the
    soft model fires fractionally and spends what it fired)."""
    kmin, kmax = _c3(p["slope_kmin"]), _c3(p["slope_kmax"])
    base, qexc = _mark_common(kmin, ctx)
    ramp = torch.clamp((ctx.B1_w - kmin) / torch.clamp_min(kmax - kmin, 1.0),
                       0.0, 1.0)
    prob_fh = torch.where(ctx.B1_w >= kmax, 1.0,
                          _c3(p["slope_pmax"]) * ramp)
    prob_fh = prob_fh * base
    prob = torch.amax(prob_fh, dim=2)                  # [R, F]
    acc = state["slope_acc"] + prob
    fire = acc >= 1.0
    if ctx.tau is None:
        acc = torch.where(fire, acc - 1.0, acc)
    else:
        tau = _c2(ctx.tau)
        fire_s = soft.select(tau, soft.unit_gate(acc - 1.0, tau, 1.0),
                             fire.to(torch.float32))
        acc = soft.select(tau, acc - fire_s,
                          torch.where(fire, acc - 1.0, acc))
        fire = fire_s
    sev = _severity(ctx, _c3(p["drain_gain"]), qexc)
    return ((base * fire.to(torch.float32)[:, :, None], sev),
            {"slope_acc": acc})


# ---------------------------------------------------------------------------
# notification stages
# ---------------------------------------------------------------------------


def _notify_window(window, ctx: NotifCtx):
    """Suppression window shared by NP/ENP/FNCC: (emission intensity,
    timer reset to 0 on emission).  Exact 0/1 hard; soft = mark level x
    a sigmoid timer gate, resetting the timer in proportion."""
    emit = ((ctx.marked > 0) & (ctx.np_tmr_t >= window)).to(torch.float32)
    np_tmr = torch.where(emit > 0, 0.0, ctx.np_tmr_t)
    if ctx.tau is not None:
        tau = _c2(ctx.tau)
        emit_s = ctx.marked * soft.unit_gate(ctx.np_tmr_t - window, tau,
                                             window)
        emit = soft.select(tau, emit_s, emit)
        np_tmr = soft.select(tau, (1.0 - emit_s) * ctx.np_tmr_t, np_tmr)
    return emit, np_tmr


def _notif_np(p, ctx: NotifCtx, state, packed=None):
    emit, np_tmr = _notify_window(_c2(p["np_window"]), ctx)
    wslot = (_c2(ctx.t) + ctx.rtt) % ctx.D
    return (emit, np_tmr, wslot), {}


def _notif_enp(p, ctx: NotifCtx, state, packed=None):
    emit, np_tmr = _notify_window(_c2(p["enp_window"]), ctx)
    wslot = (_c2(ctx.t) + ctx.rtt) % ctx.D
    return (emit, np_tmr, wslot), {}


def _notif_fncc(p, ctx: NotifCtx, state, packed=None):
    """In-path notification: the delay is the hop-proportional share of
    the one-way latency, ``rtt/2 * (h_mark+1)/hops``, clipped to
    [2, rtt]."""
    emit, np_tmr = _notify_window(_c2(p["fncc_window"]), ctx)
    h_mark = torch.argmax(ctx.mark_fh, dim=2).to(torch.float32)
    frac = (h_mark + 1.0) / torch.clamp_min(ctx.hops.to(torch.float32), 1.0)
    rtt_f = ctx.rtt.to(torch.float32)
    rtt_eff = torch.round(rtt_f * 0.5 * frac * _c2(p["fncc_scale"]))
    rtt_eff = torch.minimum(torch.clamp_min(rtt_eff.to(torch.int32), 2),
                            ctx.rtt)
    wslot = (_c2(ctx.t) + rtt_eff) % ctx.D
    return (emit, np_tmr, wslot), {}


# ---------------------------------------------------------------------------
# reaction stages
# ---------------------------------------------------------------------------


def _react_pfc(p, ctx: ReactCtx, state, packed=None):
    out = _passthrough(ctx)._replace(
        rate=torch.minimum(ctx.gen_rate, _c2(ctx.line_rate)))
    return out, {}


def _select_out(tau, soft_out: ReactOut, hard_out: ReactOut) -> ReactOut:
    """Field by field ``soft.select`` of two reaction outputs."""
    return ReactOut(*[soft.select(tau, a, b)
                      for a, b in zip(soft_out, hard_out)])


def _react_rp_soft(p, ctx: ReactCtx) -> ReactOut:
    """The reference's soft DCQCN RP (``repro.core.cc._react_rp``): every
    CNP-gated update blends by the fractional notification level; the
    integer stage machine and its byte/timer events stay hard."""
    g = _c2(p["rp_g"])
    rdf, timer = _c2(p["rp_rdf"]), _c2(p["rp_timer"])
    fr = _c2(p["rp_fr_stages"])
    line, min_rate = _c2(ctx.line_rate), _c2(p["rp_min_rate"])
    dt, tau = ctx.dt, _c2(ctx.tau)
    c = ctx.cnp
    cnp = ctx.cnp > 0
    pk = lambda a, b: soft.pick(tau, c, cnp, a, b)   # noqa: E731
    alpha_tmr = ctx.alpha_tmr + dt
    a_tick = alpha_tmr >= timer
    alpha = torch.where(a_tick, (1 - g) * ctx.alpha, ctx.alpha)
    alpha_tmr = torch.where(a_tick, 0.0, alpha_tmr)
    rp_target = pk(ctx.rate, ctx.rp_target)
    rate = pk(ctx.rate * (1 - alpha * rdf), ctx.rate)
    alpha = pk((1 - g) * alpha + g, alpha)
    byte_cnt = pk(torch.zeros_like(c), ctx.byte_cnt + ctx.rate * dt)
    tmr = pk(torch.zeros_like(c), ctx.tmr + dt)
    alpha_tmr = pk(torch.zeros_like(c), alpha_tmr)
    bc_stage = torch.where(cnp, 0, ctx.bc_stage)
    t_stage = torch.where(cnp, 0, ctx.t_stage)
    b_ev = byte_cnt >= _c2(p["rp_byte"])
    t_ev = tmr >= timer
    byte_cnt = torch.where(b_ev, 0.0, byte_cnt)
    tmr = torch.where(t_ev, 0.0, tmr)
    bc_stage = bc_stage + b_ev.to(torch.int32)
    t_stage = t_stage + t_ev.to(torch.int32)
    ev = b_ev | t_ev
    imax = torch.maximum(bc_stage, t_stage)
    imin = torch.minimum(bc_stage, t_stage)
    in_fr = imax <= fr
    in_hyper = imin > fr
    rp_target = torch.where(ev & ~in_fr & ~in_hyper,
                            rp_target + _c2(p["rp_rai"]), rp_target)
    rp_target = torch.where(
        ev & in_hyper,
        rp_target + _c2(p["rp_rhai"]) * (imin - fr).to(torch.float32),
        rp_target)
    rate = torch.where(ev, 0.5 * (rate + rp_target), rate)
    rate = soft.clip(rate, min_rate, line, tau, line)
    rp_target = soft.clip(rp_target, min_rate, line, tau, line)
    return _passthrough(ctx)._replace(
        rate=rate, rp_target=rp_target, alpha=alpha, byte_cnt=byte_cnt,
        tmr=tmr, alpha_tmr=alpha_tmr, bc_stage=bc_stage, t_stage=t_stage)


def _react_rp(p, ctx: ReactCtx, state, packed=None):
    """DCQCN RP through the ``rp_step`` kernel (stages travel as
    float32 there and come back int32)."""
    if packed is None:
        packed = cc_step.pack_rp_params(_rp_params(p, ctx.line_rate,
                                                   ctx.dt))
    out = cc_step.rp_step(
        RPState(ctx.rate, ctx.rp_target, ctx.alpha, ctx.byte_cnt, ctx.tmr,
                ctx.alpha_tmr, ctx.bc_stage.to(torch.float32),
                ctx.t_stage.to(torch.float32)),
        ctx.cnp, packed=packed)
    res = _passthrough(ctx)._replace(
        rate=out.rate, rp_target=out.target, alpha=out.alpha,
        byte_cnt=out.byte_cnt, tmr=out.tmr, alpha_tmr=out.alpha_tmr,
        bc_stage=out.bc_stage.to(torch.int32),
        t_stage=out.t_stage.to(torch.int32))
    if ctx.tau is not None:
        res = _select_out(_c2(ctx.tau), _react_rp_soft(p, ctx), res)
    return res, {}


def _erp_slope(p, ctx: ReactCtx) -> torch.Tensor:
    """Per-flow desynchronised recovery slope (deterministic jitter)."""
    return _c2(p["erp_rai"]) * (1.0 + _c2(p["erp_jitter"]) * ctx.jitter)


def _react_erp_soft(p, ctx: ReactCtx, slope):
    """The reference's soft ERP (``repro.core.cc._react_erp``): settle
    and hold blend by the notification level, the hold-down expiry is a
    sigmoid recovery gate."""
    dt, tau = ctx.dt, _c2(ctx.tau)
    settle_f, hold_T = _c2(p["erp_settle"]), _c2(p["erp_hold"])
    min_rate, line = _c2(p["erp_min_rate"]), _c2(ctx.line_rate)
    c = ctx.cnp
    cnp = ctx.cnp > 0
    pk = lambda a, b: soft.pick(tau, c, cnp, a, b)   # noqa: E731
    settle = torch.maximum(settle_f * ctx.tgt_rx, min_rate)
    rate = pk(settle, ctx.rate)
    hold = pk(hold_T.expand_as(c), torch.clamp_min(ctx.hold - dt, 0.0))
    step = slope * dt
    rec_s = (1.0 - c) * soft.unit_gate(-hold, tau, hold_T + 1e-9)
    rate = soft.select(tau, rate + rec_s * step,
                       torch.where(~cnp & (hold <= 0), rate + step, rate))
    rate = soft.clip(rate, min_rate, line, tau, line)
    return rate, hold


def _react_erp(p, ctx: ReactCtx, state, packed=None):
    """ERP: settle to the signalled fair share, hold, additive recovery
    (through the ``erp_step`` kernel)."""
    if packed is None:
        packed = cc_step.pack_erp_params(_erp_params(p, ctx.line_rate,
                                                     ctx.dt))
    slope = _erp_slope(p, ctx)
    rate, hold = cc_step.erp_step(ctx.rate, ctx.hold, ctx.cnp, ctx.tgt_rx,
                                  slope, packed=packed)
    if ctx.tau is not None:
        tau = _c2(ctx.tau)
        rate_s, hold_s = _react_erp_soft(p, ctx, slope)
        rate = soft.select(tau, rate_s, rate)
        hold = soft.select(tau, hold_s, hold)
    return _passthrough(ctx)._replace(rate=rate, hold=hold), {}


def _react_swift_soft(p, ctx: ReactCtx, cool0):
    """The reference's soft swift (``repro.core.cc._react_swift``): the
    over-target and cool-down gates become sigmoids, blending the
    multiplicative decrease against the additive recovery."""
    tau = _c2(ctx.tau)
    target, beta = _c2(p["swift_target"]), _c2(p["swift_beta"])
    ai, guard = _c2(p["swift_ai"]), _c2(p["swift_guard"])
    min_rate, line = _c2(p["swift_min_rate"]), _c2(ctx.line_rate)
    cool = torch.clamp_min(cool0 - ctx.dt, 0.0)
    g_over = soft.unit_gate(ctx.qdelay - target, tau, target + 1e-12)
    g_can = soft.unit_gate(-cool, tau, guard + 1e-12)
    factor = 1.0 - beta * (ctx.qdelay - target) \
        / torch.clamp_min(ctx.qdelay, 1e-12)
    dec = torch.maximum(ctx.rate * torch.maximum(factor, 1.0 - beta),
                        min_rate)
    cut = g_over * g_can
    rate_s = cut * dec + (1.0 - cut) * \
        (ctx.rate + (1.0 - g_over) * ai * ctx.dt)
    rate_s = soft.clip(rate_s, min_rate, line, tau, line)
    cool_s = cut * guard + (1.0 - cut) * cool
    return rate_s, cool_s


def _react_swift(p, ctx: ReactCtx, state, packed=None):
    """Delay-target throttling on the path queuing-delay estimate
    (through the ``swift_step`` kernel)."""
    if packed is None:
        packed = cc_step.pack_swift_params(_swift_params(p, ctx.line_rate,
                                                         ctx.dt))
    rate, cool = cc_step.swift_step(ctx.rate, state["swift_cool"],
                                    ctx.qdelay, packed=packed)
    if ctx.tau is not None:
        tau = _c2(ctx.tau)
        rate_s, cool_s = _react_swift_soft(p, ctx, state["swift_cool"])
        rate = soft.select(tau, rate_s, rate)
        cool = soft.select(tau, cool_s, cool)
    return _passthrough(ctx)._replace(rate=rate), {"swift_cool": cool}


# ---------------------------------------------------------------------------
# built-in registration (codes frozen in this order)
# ---------------------------------------------------------------------------


def _zeros_f(scn) -> np.ndarray:
    return np.zeros((scn.routes.shape[0],), np.float32)


MARKING.register(
    "cp", step=_mark_cp,
    params={"cp_kmin": lambda s: s.dcqcn.kmin,
            "drain_gain": lambda s: s.rev.erp_drain_gain})
MARKING.register(
    "ecp", step=_mark_ecp,
    params={"ecp_thresh": lambda s: s.rev.detect_threshold,
            "ecp_slack": lambda s: s.rev.ecp_fairness_slack,
            "drain_gain": lambda s: s.rev.erp_drain_gain})
MARKING.register(
    "slope", step=_mark_slope,
    params={"slope_kmin": lambda s: s.dcqcn.kmin,
            "slope_kmax": lambda s: s.dcqcn.kmax,
            "slope_pmax": lambda s: s.dcqcn.pmax,
            "drain_gain": lambda s: s.rev.erp_drain_gain},
    init_state=lambda scn: {"slope_acc": _zeros_f(scn)})

NOTIFICATION.register(
    "np", step=_notif_np,
    params={"np_window": lambda s: s.dcqcn.cnp_window})
NOTIFICATION.register(
    "enp", step=_notif_enp,
    params={"enp_window": lambda s: s.rev.enp_coalesce})
NOTIFICATION.register(
    "fncc", step=_notif_fncc,
    params={"fncc_window": lambda s: s.fncc.coalesce,
            "fncc_scale": lambda s: s.fncc.rtt_scale})

REACTION.register("pfc", step=_react_pfc, consumes_marks=False)
REACTION.register(
    "rp", step=_react_rp,
    params={"rp_g": lambda s: s.dcqcn.g,
            "rp_rdf": lambda s: s.dcqcn.rate_decrease_factor,
            "rp_timer": lambda s: s.dcqcn.timer_T,
            "rp_byte": lambda s: s.dcqcn.byte_counter_B,
            "rp_rai": lambda s: s.dcqcn.rai,
            "rp_rhai": lambda s: s.dcqcn.rhai,
            "rp_fr_stages": lambda s: s.dcqcn.fr_stages,
            "rp_min_rate": lambda s: s.dcqcn.min_rate},
    int_params=("rp_fr_stages",))
REACTION.register(
    "erp", step=_react_erp,
    params={"erp_settle": lambda s: s.rev.erp_settle,
            "erp_rai": lambda s: s.rev.erp_rai,
            "erp_jitter": lambda s: s.rev.erp_jitter,
            "erp_hold": lambda s: s.rev.erp_hold,
            "erp_min_rate": lambda s: s.rev.min_rate})
REACTION.register(
    "swift", step=_react_swift, consumes_marks=False,
    params={"swift_target": lambda s: s.swift.target_delay,
            "swift_beta": lambda s: s.swift.beta,
            "swift_ai": lambda s: s.swift.ai,
            "swift_guard": lambda s: s.swift.guard,
            "swift_min_rate": lambda s: s.swift.min_rate},
    init_state=lambda scn: {"swift_cool": _zeros_f(scn)})
