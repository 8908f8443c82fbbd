"""Per-flow CC updates: CUDA C++ kernels for Hopper plus their plain
PyTorch versions (port of ``repro.kernels.cc_step``).

Four stages, each elementwise over flows:
  * ``gen_np_step`` — window generation + NIC-buffer overflow + the
    notification-timer tick (fluid phases 1 and 5a);
  * ``rp_step``     — DCQCN RP (alpha EWMA, staged FR/AI/HAI recovery);
  * ``erp_step``    — the paper's ERP (jump to fair share, hold,
    jittered recovery);
  * ``swift_step``  — the delay-target reaction.

State comes as ``[R, F]`` (a Sweep batch: R runs of F flows) or ``[F]``
float32 tensors.  Constants ride in one float32 row per run
(``[R, NP]``, or ``[1, NP]`` shared; ``pack_*_params`` define the
order), so a parameter grid is ONE launch per stage per step.

Dispatch is by device, never by flag: a wrapper given CPU tensors runs
the plain version beside it; given CUDA tensors it launches its kernel
(``csrc/cc_step.cu``, built at first use) or raises.  Each launch adds
one to ``LAUNCHES[<wrapper>]``; the plain versions count nothing.  The
kernels round every operation as the plain versions do, so on the card
the two are bitwise equal (``chip_smoke.py`` holds them to that).

Autograd (the soft rollout of ``repro_torch.tune``): when a gradient is
asked for — grad mode on and an input that requires one — a wrapper
goes through ``PlainVJP``: the forward is still the kernel (the plain
version on the CPU), and the backward is the vector-Jacobian product of
the plain version, recomputed from the saved inputs.  The kernels
compute the same function as their plain versions, bit for bit, so
this is their exact gradient; it is elementwise, with per-run sums over
flows for the parameter rows, and runs no atomics.
"""

from __future__ import annotations

import ctypes

import torch

from .ref import ERPParams, RPParams, RPState, SwiftKParams

#: kernel launches per wrapper since the last ``reset_launch_counts``
LAUNCHES = {"gen_np_step": 0, "rp_step": 0, "erp_step": 0,
            "swift_step": 0}

#: float32 words each kernel moves per flow (inputs read once, outputs
#: written once) — the numerator of its bytes bound
BYTES_PER_FLOW = {"gen_np_step": 4 * (9 + 4), "rp_step": 4 * (9 + 8),
                  "erp_step": 4 * (5 + 2), "swift_step": 4 * (3 + 2)}

# (argtypes, restype) of each C entry point: (param rows, row stride,
# F, n, inputs..., outputs..., stream) -> cudaError_t
_P, _I = ctypes.c_void_p, ctypes.c_longlong
_SIGNATURES = {
    "cc_gen_np_step": ([_P, _I, _I, _I] + [_P] * 14, ctypes.c_int),
    "cc_rp_step": ([_P, _I, _I, _I] + [_P] * 18, ctypes.c_int),
    "cc_erp_step": ([_P, _I, _I, _I] + [_P] * 8, ctypes.c_int),
    "cc_swift_step": ([_P, _I, _I, _I] + [_P] * 6, ctypes.c_int),
    # yardsticks at swift's grid: an empty kernel (n, stream) and a
    # three-in two-out copy (a, b, c, x, y, n, stream)
    "cc_swift_floor": ([_I, _P], ctypes.c_int),
    "cc_swift_copy": ([_P] * 5 + [_I, _P], ctypes.c_int),
    "cc_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    from .build import load
    return load("cc_step", _SIGNATURES)


# ---------------------------------------------------------------------------
# parameter rows
# ---------------------------------------------------------------------------

def _row(*vals) -> torch.Tensor:
    """[R, NP] float32 rows from scalars or [R] tensors (R = 1 when every
    value is a python scalar or a 0-d tensor)."""
    ts = [v for v in vals if isinstance(v, torch.Tensor)]
    device = ts[0].device if ts else torch.device("cpu")
    cols = [torch.as_tensor(v, dtype=torch.float32, device=device)
            .reshape(-1) for v in vals]
    r = max(c.shape[0] for c in cols)
    return torch.stack([c.expand(r) for c in cols], dim=1).contiguous()


def pack_gen_np_params(t_sec, dt) -> torch.Tensor:
    return _row(t_sec, dt)


def pack_rp_params(p: RPParams) -> torch.Tensor:
    return _row(p.g, p.rate_decrease, p.timer_T, p.byte_B, p.rai, p.rhai,
                p.fr_stages, p.min_rate, p.line_rate, p.dt)


def pack_erp_params(p: ERPParams) -> torch.Tensor:
    return _row(p.settle, p.hold, p.min_rate, p.line_rate, p.dt)


def pack_swift_params(p: SwiftKParams) -> torch.Tensor:
    return _row(p.target, p.beta, p.ai, p.guard, p.min_rate, p.line_rate,
                p.dt)


# ---------------------------------------------------------------------------
# launch plumbing
# ---------------------------------------------------------------------------

def _check(name: str, xs, rows: torch.Tensor, n_par: int):
    """Validate a launch; returns (device, F, n).  Every state tensor
    must share one shape ([R, F] or [F]), be float32, contiguous and on
    one device; the rows must be [R or 1, n_par] float32 there too."""
    shape, dev = xs[0].shape, xs[0].device
    for x in xs:
        if x.shape != shape:
            raise ValueError(f"{name}: state shapes differ "
                             f"({tuple(x.shape)} vs {tuple(shape)})")
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {x.dtype}")
        if x.device != dev:
            raise ValueError(f"{name}: tensors on {x.device} and {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if len(shape) not in (1, 2):
        raise ValueError(f"{name}: state must be [F] or [R, F], got "
                         f"{tuple(shape)}")
    n_runs = shape[0] if len(shape) == 2 else 1
    if (rows.dim() != 2 or rows.shape[1] != n_par
            or rows.shape[0] not in (1, n_runs)):
        raise ValueError(f"{name}: parameter rows must be [1 or {n_runs}, "
                         f"{n_par}], got {tuple(rows.shape)}")
    if rows.dtype != torch.float32 or rows.device != dev \
            or not rows.is_contiguous():
        raise ValueError(f"{name}: parameter rows must be contiguous "
                         f"float32 on {dev}")
    return dev, shape[-1], xs[0].numel()


def _launch(name: str, sym: str, xs, rows: torch.Tensor, n_out: int):
    """Launch kernel ``sym`` on CUDA tensors ``xs``; returns outputs."""
    dev, F, n = _check(name, xs, rows, rows.shape[1])
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors on {dev} but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    outs = [torch.empty_like(xs[0]) for _ in range(n_out)]
    if n == 0:                      # nothing to launch, nothing counted
        return outs
    lib = _lib()
    stride = rows.shape[1] if rows.shape[0] > 1 else 0
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(lib, sym)(rows.data_ptr(), stride, F, n,
                            *[x.data_ptr() for x in xs],
                            *[o.data_ptr() for o in outs], stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed: "
                           f"{lib.cc_error_string(err).decode()} ({err})")
    LAUNCHES[name] += 1
    return outs


def _route(name: str, x: torch.Tensor) -> str:
    """'cpu' -> plain version, 'cuda' -> kernel; anything else raises."""
    if x.device.type in ("cpu", "cuda"):
        return x.device.type
    raise ValueError(f"{name}: no kernel or plain version for device "
                     f"{x.device}")


class PlainVJP(torch.autograd.Function):
    """``forward(fwd, plain, *xs)`` returns ``fwd(*xs)`` (a tuple of
    tensors); the backward is the vector-Jacobian product of
    ``plain(*xs)``, which must compute the same function, recomputed
    from the saved inputs under autograd."""

    @staticmethod
    def forward(ctx, fwd, plain, *xs):
        ctx.plain = plain
        ctx.save_for_backward(*xs)
        return tuple(fwd(*xs))

    @staticmethod
    def backward(ctx, *grads):
        xs = ctx.saved_tensors
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            ins = [x.detach().requires_grad_(n) for x, n in zip(xs, need)]
            outs = ctx.plain(*ins)
            pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
            wrt = [x for x, n in zip(ins, need) if n]
            got = iter(torch.autograd.grad(
                [o for o, _ in pairs], wrt, [g for _, g in pairs],
                allow_unused=True) if pairs else [None] * len(wrt))
        res = []
        for x, n in zip(xs, need):
            g = next(got) if n else None
            res.append(torch.zeros_like(x) if n and g is None else g)
        return (None, None, *res)


def _wants_grad(xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def _cols(rows: torch.Tensor, like: torch.Tensor):
    """Per-run parameter columns broadcasting against ``like``."""
    cols = rows.unbind(1)
    if like.dim() == 1:
        return [c.reshape(()) if c.numel() == 1 else c for c in cols]
    return [c[:, None] for c in cols]


# ---------------------------------------------------------------------------
# fused generation + notification timer (fluid phases 1 and 5a)
# ---------------------------------------------------------------------------

def gen_np_plain(nicq, offered, dropped, np_tmr, gen_rate, t_start, t_stop,
                 volume, nic_buffer, rows):
    """Plain version of the ``gen_np`` kernel; ``rows`` = [·, (t_sec, dt)]."""
    t_sec, dt = _cols(rows, nicq)
    active = (t_sec >= t_start) & (t_sec < t_stop)
    gen = torch.where(active, gen_rate, 0.0) * dt
    gen = torch.minimum(gen, torch.clamp_min(volume - offered, 0.0))
    nicq = nicq + gen
    over = torch.clamp_min(nicq - nic_buffer, 0.0)
    return (nicq - over, offered + gen - over, dropped + over,
            np_tmr + dt)


def gen_np_step(nicq, offered, dropped, np_tmr, gen_rate, t_start, t_stop,
                volume, nic_buffer, *, t_sec, dt):
    """Window generator + NIC overflow + notification-timer tick.

    ``t_sec`` / ``dt`` are float32 scalars or per-run [R] tensors.
    Returns ``(nicq', offered', dropped', np_tmr + dt)``.
    """
    xs = [nicq, offered, dropped, np_tmr, gen_rate, t_start, t_stop,
          volume, nic_buffer]
    rows = pack_gen_np_params(t_sec, dt).to(nicq.device)
    if _route("gen_np_step", nicq) == "cpu":
        _check("gen_np_step", xs, rows, 2)
        fwd = gen_np_plain
    else:
        def fwd(*a):
            return _launch("gen_np_step", "cc_gen_np_step", list(a[:-1]),
                           a[-1], 4)
    if _wants_grad(xs + [rows]):
        return PlainVJP.apply(fwd, gen_np_plain, *xs, rows)
    return tuple(fwd(*xs, rows))


# ---------------------------------------------------------------------------
# DCQCN RP
# ---------------------------------------------------------------------------

def rp_plain(st: RPState, cnp: torch.Tensor, rows: torch.Tensor) -> RPState:
    """Plain version of the ``rp`` kernel (``cnp`` a float level)."""
    (g, rate_decrease, timer_T, byte_B, rai, rhai, fr_stages, min_rate,
     line_rate, dt) = _cols(rows, st.rate)
    c = cnp > 0
    rate, target, alpha = st.rate, st.target, st.alpha
    alpha_tmr = st.alpha_tmr + dt
    a_tick = alpha_tmr >= timer_T
    alpha = torch.where(a_tick, (1 - g) * alpha, alpha)
    alpha_tmr = torch.where(a_tick, 0.0, alpha_tmr)

    target = torch.where(c, rate, target)
    new_rate = torch.where(c, rate * (1 - alpha * rate_decrease), rate)
    alpha = torch.where(c, (1 - g) * alpha + g, alpha)
    byte_cnt = torch.where(c, 0.0, st.byte_cnt + rate * dt)
    tmr = torch.where(c, 0.0, st.tmr + dt)
    alpha_tmr = torch.where(c, 0.0, alpha_tmr)
    bc_stage = torch.where(c, 0.0, st.bc_stage)
    t_stage = torch.where(c, 0.0, st.t_stage)
    rate = new_rate

    b_ev = byte_cnt >= byte_B
    t_ev = tmr >= timer_T
    byte_cnt = torch.where(b_ev, 0.0, byte_cnt)
    tmr = torch.where(t_ev, 0.0, tmr)
    bc_stage = bc_stage + b_ev.float()
    t_stage = t_stage + t_ev.float()
    ev = b_ev | t_ev
    imax = torch.maximum(bc_stage, t_stage)
    imin = torch.minimum(bc_stage, t_stage)
    in_fr = imax <= fr_stages
    in_hyper = imin > fr_stages
    target = torch.where(ev & ~in_fr & ~in_hyper, target + rai, target)
    target = torch.where(ev & in_hyper, target + rhai * (imin - fr_stages),
                         target)
    rate = torch.where(ev, 0.5 * (rate + target), rate)
    rate = torch.minimum(torch.maximum(rate, min_rate), line_rate)
    target = torch.minimum(torch.maximum(target, min_rate), line_rate)
    return RPState(rate, target, alpha, byte_cnt, tmr, alpha_tmr,
                   bc_stage, t_stage)


def rp_step(st: RPState, cnp: torch.Tensor, p: RPParams | None = None, *,
            packed: torch.Tensor | None = None) -> RPState:
    """DCQCN RP update for every flow of every run; ``packed`` (from
    ``pack_rp_params``) replaces ``p``."""
    rows = pack_rp_params(p) if packed is None else packed
    rows = rows.to(st.rate.device)
    cnp = cnp.to(torch.float32)
    xs = list(st) + [cnp]
    if _route("rp_step", st.rate) == "cpu":
        _check("rp_step", xs, rows, 10)
        fwd = _rp_flat
    else:
        def fwd(*a):
            return _launch("rp_step", "cc_rp_step", list(a[:-1]), a[-1], 8)
    if _wants_grad(xs + [rows]):
        return RPState(*PlainVJP.apply(fwd, _rp_flat, *xs, rows))
    return RPState(*fwd(*xs, rows))


def _rp_flat(*a):
    """``rp_plain`` over flat inputs (8 state tensors, cnp, rows)."""
    return tuple(rp_plain(RPState(*a[:8]), a[8], a[9]))


# ---------------------------------------------------------------------------
# the paper's ERP
# ---------------------------------------------------------------------------

def erp_plain(rate, hold, cnp, tgt_rx, slope, rows):
    """Plain version of the ``erp`` kernel (``cnp`` a float level)."""
    settle, hold_T, min_rate, line_rate, dt = _cols(rows, rate)
    c = cnp > 0
    rate = torch.where(c, torch.maximum(settle * tgt_rx, min_rate), rate)
    hold = torch.where(c, hold_T, torch.clamp_min(hold - dt, 0.0))
    rate = torch.where(~c & (hold <= 0), rate + slope * dt, rate)
    rate = torch.minimum(torch.maximum(rate, min_rate), line_rate)
    return rate, hold


def erp_step(rate, hold, cnp, tgt_rx, slope, p: ERPParams | None = None,
             *, packed: torch.Tensor | None = None):
    """ERP update; returns ``(rate', hold')``."""
    rows = pack_erp_params(p) if packed is None else packed
    rows = rows.to(rate.device)
    xs = [rate, hold, cnp.to(torch.float32), tgt_rx, slope]
    if _route("erp_step", rate) == "cpu":
        _check("erp_step", xs, rows, 5)
        fwd = erp_plain
    else:
        def fwd(*a):
            return _launch("erp_step", "cc_erp_step", list(a[:-1]), a[-1], 2)
    if _wants_grad(xs + [rows]):
        return PlainVJP.apply(fwd, erp_plain, *xs, rows)
    return tuple(fwd(*xs, rows))


# ---------------------------------------------------------------------------
# delay-target reaction (Swift-like)
# ---------------------------------------------------------------------------

def swift_plain(rate, cool, qdelay, rows):
    """Plain version of the ``swift`` kernel."""
    target, beta, ai, guard, min_rate, line_rate, dt = _cols(rows, rate)
    cool = torch.clamp_min(cool - dt, 0.0)
    over = qdelay > target
    can = cool <= 0.0
    factor = 1.0 - beta * (qdelay - target) / torch.clamp_min(qdelay,
                                                               1e-12)
    dec = torch.maximum(rate * torch.maximum(factor, 1.0 - beta), min_rate)
    rate = torch.where(over & can, dec,
                       torch.where(over, rate, rate + ai * dt))
    cool = torch.where(over & can, guard, cool)
    rate = torch.minimum(torch.maximum(rate, min_rate), line_rate)
    return rate, cool


def swift_step(rate, cool, qdelay, p: SwiftKParams | None = None, *,
               packed: torch.Tensor | None = None):
    """Delay-target update; returns ``(rate', cool')``."""
    rows = pack_swift_params(p) if packed is None else packed
    rows = rows.to(rate.device)
    xs = [rate, cool, qdelay]
    if _route("swift_step", rate) == "cpu":
        _check("swift_step", xs, rows, 7)
        fwd = swift_plain
    else:
        def fwd(*a):
            return _launch("swift_step", "cc_swift_step", list(a[:-1]),
                           a[-1], 2)
    if _wants_grad(xs + [rows]):
        return PlainVJP.apply(fwd, swift_plain, *xs, rows)
    return tuple(fwd(*xs, rows))
