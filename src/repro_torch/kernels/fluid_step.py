"""Whole-step fluid megakernel: the CUDA C++ kernel for Hopper and its
plain version (port of ``repro.kernels.fluid_step``).

  * ``megastep``       — one launch = one ``dt`` update of every run of a
    batch: ``(state', StepTrace)``;
  * ``megastep_block`` — one launch = one decimated trace window of
    ``n_substeps`` steps: ``(state', TraceSample)``, the window folded in
    the kernel the way ``core.simulator`` folds it on the host.

The kernel (``csrc/fluid_step.cu``) runs one CTA per run with the state
in global memory and the per-queue sums in shared memory; stages are
selected per run by code inside it, so a whole CC-stage grid is one
launch.  It is held bitwise to the port's flow tier on the card.

Dispatch is by device, never by flag: on CPU tensors both entry points
run their plain version, which is the port's step itself (``body``, as
the reference's interpret mode runs its ``step_body_fn``) and, for the
block, the host's window fold (``acc_init``/``acc_update``/
``make_sample``); on CUDA tensors they launch the kernel or raise.  Each
launch adds one to ``LAUNCHES[<entry point>]``.

Limits, checked on every device so the plain version models the kernel:
the kernel knows the built-in CC stages only (a registry holding another
raises, naming it), at most ``MEGA_MAX_HOPS`` hops, and per-queue sums
that fit ``MEGA_SMEM_CAP`` bytes of shared memory (``mega_footprint``).
There is no fallback to the flow tier.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

#: kernel launches per entry point since the last ``reset_launch_counts``
LAUNCHES = {"megastep": 0, "megastep_block": 0}

#: shared memory one CTA may use on an H100 (227 KB of the SM's 256 KB)
MEGA_SMEM_CAP = 232448
#: hops per path the kernel holds per flow (``kMaxHops`` in the source)
MEGA_MAX_HOPS = 8

#: the stages the kernel was built with, in code order (``cc`` freezes
#: the built-in order)
BUILTIN_STAGES = {"marking": ("cp", "ecp", "slope"),
                  "notification": ("np", "enp", "fncc"),
                  "reaction": ("pfc", "rp", "erp", "swift")}

#: FluidState leaves in the kernel's order (``Leaf`` in the source), the
#: ``cc`` dict expanded in place
STATE_LEAVES = ("qh", "nicq", "delivered", "offered", "dropped", "est",
                "paused", "rate", "rp_target", "alpha", "byte_cnt", "tmr",
                "alpha_tmr", "bc_stage", "t_stage", "hold", "np_tmr",
                "trig_buf", "tgt_buf", "path_idx", "slope_acc",
                "swift_cool", "t")
CC_LEAVES = ("slope_acc", "swift_cool")

#: the scalar head of the per-run float row (``FRow`` in the source);
#: the packed rp / erp / swift reaction rows follow it
FLOAT_ROW = ("dt", "line_rate", "xoff", "xon", "pool_xoff", "port_buffer",
             "ecp_beta", "cp_kmin", "drain_gain", "ecp_thresh",
             "ecp_slack", "slope_kmin", "slope_kmax", "slope_pmax",
             "np_window", "enp_window", "fncc_window", "fncc_scale",
             "erp_rai", "erp_jitter", "window")
REACT_ROWS = (("rp", 10), ("erp", 5), ("swift", 7))
INT_ROW = ("mark_code", "notif_code", "react_code", "route_code")

_P, _I = ctypes.c_void_p, ctypes.c_longlong
_N = len(STATE_LEAVES)


class MegaArgs(ctypes.Structure):
    """The kernel's operands (``struct MegaArgs`` in the source)."""

    _fields_ = ([(n, _I) for n in ("R", "F", "H", "K", "L", "V", "S", "D",
                                   "NSW", "n_substeps", "block", "nfp",
                                   "nip")]
                + [(n, _P) for n in (
                    "fpar", "ipar", "gen_rate", "t_start", "t_stop",
                    "volume", "cap_ext", "nic_buffer", "jitter", "sink_ext",
                    "rtt", "alt_routes", "alt_hops", "vc", "red_perm",
                    "red_off", "pool_perm", "pool_off")]
                + [("st_in", _P * _N), ("st_out", _P * _N)]
                + [(n, _P) for n in (
                    "tr_inst_thr", "tr_max_q", "tr_n_paused", "tr_marked",
                    "tr_cnp", "tr_n_nonmin", "tr_ctrl", "tr_pause_time",
                    "tr_vc_stall", "scratch")])


_SIGNATURES = {
    "fs_mega": ([_P, _I, _P], ctypes.c_int),
    "fs_args_size": ([], _I),
    "fs_row_sizes": ([_I], _I),
    "fs_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    from .build import load
    lib = load("fluid_step", _SIGNATURES)
    if lib.fs_args_size() != ctypes.sizeof(MegaArgs):
        raise RuntimeError(
            f"fluid_step: MegaArgs is {ctypes.sizeof(MegaArgs)} B here and "
            f"{lib.fs_args_size()} B in csrc/fluid_step.cu")
    if lib.fs_row_sizes(0) != n_float_row() or \
            lib.fs_row_sizes(1) != len(INT_ROW):
        raise RuntimeError("fluid_step: parameter rows differ between "
                           "kernels/fluid_step.py and csrc/fluid_step.cu")
    return lib


def n_float_row() -> int:
    return len(FLOAT_ROW) + sum(n for _, n in REACT_ROWS)


def mega_footprint(n_queues: int, n_links: int, n_switches: int,
                   n_vcs: int) -> int:
    """Shared-memory bytes of one CTA: five [S + 1] and six [L + 1]
    per-queue / per-wire float arrays, the switch pool, 32 warp
    partials and 4 + V counters (the layout of ``mega_kernel``)."""
    return 4 * (5 * (n_queues + 1) + 6 * (n_links + 1) + n_switches + 32
                + 4 + n_vcs)


def check_stages() -> None:
    """Refuse a registry that holds a stage the kernel has no body for."""
    from ..core import cc
    for reg in cc.FAMILIES:
        built = BUILTIN_STAGES[reg.family]
        extra = [n for n in reg.names() if n not in built]
        if extra:
            raise ValueError(
                f"use_kernels='mega': the megakernel is built with the "
                f"{reg.family} stages {built}; registered stage(s) "
                f"{extra} have no kernel body")


def check_shape(st, sd, *, n_switches: int, n_vcs: int) -> int:
    """Validate one launch's geometry; returns its shared-memory bytes."""
    R, F, K, H = sd.alt_routes.shape
    L = sd.cap_ext.shape[1] - 1
    if H > MEGA_MAX_HOPS:
        raise ValueError(
            f"use_kernels='mega': paths of {H} hops exceed MEGA_MAX_HOPS "
            f"({MEGA_MAX_HOPS})")
    if set(st.cc) != set(CC_LEAVES):
        raise ValueError(f"use_kernels='mega': cc state {sorted(st.cc)} is "
                         f"not the kernel's {list(CC_LEAVES)}")
    smem = mega_footprint(L * n_vcs, L, n_switches, n_vcs)
    if smem > MEGA_SMEM_CAP:
        raise ValueError(
            f"use_kernels='mega': per-queue sums of {L * n_vcs} queues, "
            f"{L} links and {n_switches} switches need {smem} B of shared "
            f"memory, over MEGA_SMEM_CAP ({MEGA_SMEM_CAP} B); run the flow "
            f"tier (use_kernels=False)")
    return smem


class MegaPlan(NamedTuple):
    """Per-run parameter rows of one batch, packed once."""

    frow: torch.Tensor        # [R, n_float_row()] f32
    irow: torch.Tensor        # [R, len(INT_ROW)] int32


def mega_plan(par, packed_react: dict, dt: torch.Tensor,
              window: float = 0.0) -> MegaPlan:
    """Pack ``StepParams`` (+ the packed reaction rows and the trace
    window length in seconds) into the kernel's two per-run rows."""
    R = par.line_rate.shape[0]
    dev = par.line_rate.device
    src = {"dt": dt.to(torch.float32).expand(R),
           "window": torch.full((R,), window, dtype=torch.float32,
                                device=dev),
           **{f: getattr(par, f) for f in ("line_rate", "xoff", "xon",
                                           "pool_xoff", "port_buffer",
                                           "ecp_beta")},
           **par.mark, **par.notif, **par.react}
    cols = [src[f].to(torch.float32).reshape(R, 1) for f in FLOAT_ROW]
    cols += [packed_react[name].to(dev).expand(R, n) for name, n in REACT_ROWS]
    irow = torch.stack([getattr(par, f).to(torch.int32) for f in INT_ROW],
                       dim=1)
    return MegaPlan(frow=torch.cat(cols, dim=1).contiguous(),
                    irow=irow.contiguous())


def _state_leaves(st):
    return [st.cc[n] if n in CC_LEAVES else getattr(st, n)
            for n in STATE_LEAVES]


def _launch(name: str, st, sd, plan, mplan: MegaPlan, *, n_switches: int,
            n_vcs: int, n_substeps: int, block: bool, smem: int):
    from ..core.fluid import FluidState
    dev = st.nicq.device
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors on {dev} but the current device "
                         f"is cuda:{torch.cuda.current_device()}")
    R, F, K, H = sd.alt_routes.shape
    L = sd.cap_ext.shape[1] - 1
    V = int(n_vcs)
    D = st.trig_buf.shape[1]
    ins = [x.contiguous() for x in _state_leaves(st)]
    for n, x in zip(STATE_LEAVES, ins):
        if x.device != dev or x.element_size() != 4:
            raise ValueError(f"{name}: state leaf {n} must be a 4-byte "
                             f"tensor on {dev}")
    outs = [torch.empty_like(x) for x in ins]
    f32, i32 = torch.float32, torch.int32
    flag = i32 if block else torch.bool
    tr = dict(inst_thr=torch.empty((R, F), dtype=f32, device=dev),
              max_q=torch.empty((R,), dtype=f32, device=dev),
              n_paused=torch.empty((R,), dtype=i32, device=dev),
              marked=torch.empty((R, F), dtype=flag, device=dev),
              cnp=torch.empty((R, F), dtype=flag, device=dev),
              n_nonmin=torch.empty((R,), dtype=i32, device=dev),
              ctrl=torch.empty((R, F), dtype=f32, device=dev),
              pause_time=torch.empty((R,), dtype=f32, device=dev),
              vc_stall=torch.empty((R, V), dtype=f32, device=dev))
    scratch = torch.empty((R, F * H * 4), dtype=f32, device=dev)
    scn = {f: getattr(sd, f).contiguous() for f in (
        "gen_rate", "t_start", "t_stop", "volume", "cap_ext", "nic_buffer",
        "jitter", "sink_ext", "rtt", "alt_routes", "alt_hops", "vc",
        "red_perm", "red_off", "pool_perm")}
    args = MegaArgs(
        R=R, F=F, H=H, K=K, L=L, V=V, S=L * V, D=D, NSW=int(n_switches),
        n_substeps=int(n_substeps), block=int(block),
        nfp=mplan.frow.shape[1], nip=mplan.irow.shape[1],
        fpar=mplan.frow.data_ptr(), ipar=mplan.irow.data_ptr(),
        pool_off=plan.pool_off.data_ptr(),
        st_in=(_P * _N)(*[x.data_ptr() for x in ins]),
        st_out=(_P * _N)(*[x.data_ptr() for x in outs]),
        scratch=scratch.data_ptr(),
        **{k: v.data_ptr() for k, v in scn.items()},
        **{f"tr_{k}": v.data_ptr() for k, v in tr.items()})
    lib = _lib()
    err = lib.fs_mega(ctypes.byref(args), smem,
                      torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed: "
                           f"{lib.fs_error_string(err).decode()} ({err})")
    LAUNCHES[name] += 1
    vals = dict(zip(STATE_LEAVES, outs))
    new = FluidState(**{f: vals[f] for f in FluidState._fields
                        if f != "cc"},
                     cc={k: vals[k] for k in CC_LEAVES})
    return new, tr


def _check(st, sd, n_switches, n_vcs) -> int:
    check_stages()
    return check_shape(st, sd, n_switches=n_switches, n_vcs=n_vcs)


def megastep(st, sd, par, plan, mplan: MegaPlan, *, body, n_switches: int,
             n_vcs: int):
    """One whole-step launch: ``(state', StepTrace)``.

    ``body(st) -> (state', StepTrace)`` is the port's step (the plain
    version, run on CPU tensors); ``plan`` the batch's ``ReducePlan``
    (its ``pool_off`` CSR), ``mplan`` its packed rows (``mega_plan``).
    """
    smem = _check(st, sd, n_switches, n_vcs)
    if st.nicq.device.type == "cpu":
        return body(st)
    if st.nicq.device.type != "cuda":
        raise ValueError(f"megastep: no kernel or plain version for device "
                         f"{st.nicq.device}")
    from ..core.fluid import StepTrace
    new, tr = _launch("megastep", st, sd, plan, mplan, n_switches=n_switches,
                      n_vcs=n_vcs, n_substeps=1, block=False, smem=smem)
    return new, StepTrace(delivered=new.delivered, rate=new.rate, **tr)


def megastep_block(st, sd, par, plan, mplan: MegaPlan, *, body,
                   n_substeps: int, acc_init, acc_update, make_sample,
                   n_vcs: int, n_switches: int):
    """One decimated trace window as ONE launch: ``(state', sample)``.

    ``mplan`` must carry the window length (``mega_plan(window=...)``).
    On CPU tensors the plain version steps ``body`` ``n_substeps`` times
    and folds the window with ``acc_init`` / ``acc_update`` /
    ``make_sample`` (the host scan's own functions; ``make_sample(st,
    d0, acc)``)."""
    smem = _check(st, sd, n_switches, n_vcs)
    if st.nicq.device.type == "cpu":
        d0 = st.delivered
        acc = acc_init(st, n_vcs)
        for _ in range(n_substeps):
            st, tr = body(st)
            acc = acc_update(acc, tr)
        return st, make_sample(st, d0, acc)
    if st.nicq.device.type != "cuda":
        raise ValueError(f"megastep_block: no kernel or plain version for "
                         f"device {st.nicq.device}")
    from ..core.simulator import TraceSample
    new, tr = _launch("megastep_block", st, sd, plan, mplan,
                      n_switches=n_switches, n_vcs=n_vcs,
                      n_substeps=n_substeps, block=True, smem=smem)
    return new, TraceSample(delivered=new.delivered, rate=new.rate, **tr)
