"""Whole-step fluid megakernel: the CUDA C++ kernel for Hopper and its
plain version (port of ``repro.kernels.fluid_step``).

  * ``megastep``       — one launch = one ``dt`` update of every run of a
    batch: ``(state', StepTrace)``;
  * ``megastep_block`` — one launch = one decimated trace window of
    ``n_substeps`` steps: ``(state', TraceSample)``, the window folded in
    the kernel the way ``core.simulator`` folds it on the host.

The kernel (``csrc/fluid_step.cu``) runs one thread-block cluster per
run: ``mega_geometry`` gives each run c CTAs (``cluster_size``) and
splits its flows, wires and switches over them in equal slices; state
stays in global memory, the per-queue and per-wire values live in
shared-memory replicas that their owners push over the cluster, and the
run's incidence rows and paths are staged in shared memory (as the int32
tables of ``mega_plan``) where they fit.  Stages are selected per run by
code inside it, so a whole CC-stage grid is one launch.  It is held
bitwise to the port's flow tier on the card.

Dispatch is by device, never by flag: on CPU tensors both entry points
run their plain version, which is the port's step itself (``body``, as
the reference's interpret mode runs its ``step_body_fn``) and, for the
block, the host's window fold (``acc_init``/``acc_update``/
``make_sample``); on CUDA tensors they launch the kernel or raise.  Each
launch adds one to ``LAUNCHES[<entry point>]``.

Limits, checked on every device so the plain version models the kernel:
the kernel knows the built-in CC stages only (a registry holding another
raises, naming it), at most ``MEGA_MAX_HOPS`` hops, and per-queue
replicas that fit ``MEGA_SMEM_CAP`` bytes of shared memory in one CTA
(``mega_footprint``, the layout at cluster size 1 with nothing staged).
There is no fallback to the flow tier.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Callable, NamedTuple

import numpy as np
import torch

#: kernel launches per entry point since the last ``reset_launch_counts``
LAUNCHES = {"megastep": 0, "megastep_block": 0}
#: the geometry of each entry point's last launch (``MegaGeometry``)
GEOMETRY: dict = {}

#: shared memory one CTA may use on an H100 (227 KB of the SM's 256 KB)
MEGA_SMEM_CAP = 232448
#: hops per path the kernel holds per flow (``kMaxHops`` in the source)
MEGA_MAX_HOPS = 8
#: CTAs a run's cluster may take (``kMaxCluster``: the portable cluster
#: size on Hopper)
MEGA_MAX_CLUSTER = 8
#: threads of one CTA (``kThreads`` in the source)
MEGA_THREADS = 384
#: SMs of an H100 SXM: the plan's default (the wrapper asks the card)
N_SM = 132

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
                                   "nip", "cluster", "q_cap", "flow_cap",
                                   "rows_cap", "pool_cap", "push_rows",
                                   "stage_paths")]
                + [(n, _P) for n in (
                    "fpar", "ipar", "gen_rate", "t_start", "t_stop",
                    "volume", "cap_ext", "nic_buffer", "jitter", "sink_ext",
                    "rtt", "path_q", "path_n", "path_pos", "red_rows",
                    "red_off", "pool_rows", "pool_off")]
                + [("st_in", _P * _N), ("st_out", _P * _N)]
                + [(n, _P) for n in (
                    "tr_inst_thr", "tr_max_q", "tr_n_paused", "tr_marked",
                    "tr_cnp", "tr_n_nonmin", "tr_ctrl", "tr_pause_time",
                    "tr_vc_stall", "scratch")])


_SIGNATURES = {
    "fs_mega": ([_P, _I, _P], ctypes.c_int),
    "fs_max_clusters": ([_I, _I], _I),
    "fs_args_size": ([], _I),
    "fs_row_sizes": ([_I], _I),
    "fs_error_string": ([ctypes.c_int], ctypes.c_char_p),
    "fs_phase_timers": ([ctypes.c_int, ctypes.c_int, _P], ctypes.c_int),
    "fs_phase_read": ([_P, _P, _P, _P], ctypes.c_int),
    "fs_phase_marks": ([], _I),
}

#: the phase timers' marks in the step loop of ``csrc/fluid_step.cu``, in
#: slot order: where the mark sits (the top of a step, the barrier it
#: follows, the loop's exit) and the ``// ---- ...`` phase that the
#: interval ending there closes.  Slot 0 (after the first step) and the
#: exit close the tail of a step, after its last barrier.
PHASES = (
    ("step", "this CTA's partials to rank 0, which folds the run's trace"),
    ("run_sync", "0. path selection (min / valiant / ugal)"),
    ("__syncthreads", "0. path selection (min / valiant / ugal)"),
    ("run_sync", "0. path selection (min / valiant / ugal)"),
    ("run_sync", "1. generation (+ notification-timer tick), "
                 "2a. transfer sums"),
    ("__syncthreads", "1. generation (+ notification-timer tick), "
                      "2a. transfer sums"),
    ("run_sync", "1. generation (+ notification-timer tick), "
                 "2a. transfer sums"),
    ("run_sync", "2b. transfers: shares, queues, delivery, "
                 "crossing-rate EWMA"),
    ("__syncthreads", "3. PFC: per-queue hysteresis, wire sums, "
                      "pool inputs"),
    ("run_sync", "3. PFC: per-queue hysteresis, wire sums, pool inputs"),
    ("run_sync", "3b. the switch pool; 4a. fair-share surplus inputs"),
    ("__syncthreads", "3c. paused = max(hysteresis, pool); "
                      "4a. surplus sums"),
    ("run_sync", "3c. paused = max(hysteresis, pool); 4a. surplus sums"),
    ("__syncthreads", "4b. marking, 5. notification + delay line, "
                      "6. reaction"),
    ("run_sync", "this CTA's partials to rank 0, which folds the run's trace"),
    ("exit", "this CTA's partials to rank 0, which folds the run's trace"),
)


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


def smem_words(*, S: int, L: int, NSW: int, V: int, K: int, H: int,
               q_cap: int, flow_cap: int, rows_cap: int, pool_cap: int,
               push_rows: bool, stage_paths: bool) -> int:
    """4-byte words of one CTA's shared memory (``smem_words`` in the
    source): the replicas (3 per-queue and 7 per-wire arrays, the switch
    pool), the CTA's own per-queue sums, 32 warp maxima, 4 + V counters,
    the cluster's partials, the pool rows of its switches, then its
    queues' pushed rows (3 channels) and its flows' staged paths (queue
    ids, hop counts and, with pushed rows, the rows' positions)."""
    return (3 * (S + 1) + 7 * (L + 1) + NSW + 3 * q_cap + 32 + (4 + V)
            + MEGA_MAX_CLUSTER * (3 + V) + pool_cap
            + (3 * rows_cap if push_rows else 0)
            + ((flow_cap * K * (H + 1) + (flow_cap * K * H if push_rows
                                          else 0)) if stage_paths else 0))


def mega_footprint(n_queues: int, n_links: int, n_switches: int,
                   n_vcs: int) -> int:
    """Shared-memory bytes one CTA needs at least: the layout at cluster
    size 1 (it owns every queue and every link's pool row) with no rows
    or paths in shared memory.  A larger cluster needs less, and rows
    and paths go there only where they fit."""
    return 4 * smem_words(S=n_queues, L=n_links, NSW=n_switches, V=n_vcs,
                          K=1, H=0, q_cap=n_queues, flow_cap=0, rows_cap=0,
                          pool_cap=n_links, push_rows=False,
                          stage_paths=False)


def slices(n: int, c: int) -> list[int]:
    """Starts of the c equal slices of n items, and n (``slice`` in the
    source): rank i owns [out[i], out[i + 1])."""
    return [n * i // c for i in range(c + 1)]


def cluster_size(R: int, F: int, n_sm: int = N_SM) -> int:
    """CTAs a run gets before the residency check: the SMs a run would
    have to itself, at most ``MEGA_MAX_CLUSTER`` and at most the CTAs
    its F flows fill (``MEGA_THREADS`` a CTA): a cluster barrier costs
    more than a CTA's (measured, PERF.md), so a run whose flows fit one
    CTA stays one CTA."""
    return min(MEGA_MAX_CLUSTER, max(1, n_sm // max(R, 1)),
               max(1, -(-F // MEGA_THREADS)))


class MegaGeometry(NamedTuple):
    """One batch's launch geometry (``mega_geometry``)."""

    cluster: int          # CTAs a run (cluster size c)
    q_cap: int            # queues the largest slice owns (V x wires)
    flow_cap: int         # flows the largest slice owns
    rows_cap: int         # incidence rows of the largest queue slice
    pool_cap: int         # pool rows of the largest switch slice
    push_rows: bool       # flows push channel rows into their owners
    stage_paths: bool     # paths staged in shared memory
    smem_bytes: int       # dynamic shared memory a CTA


def mega_geometry(R: int, F: int, K: int, H: int, L: int, V: int,
                  NSW: int, red_off: np.ndarray, pool_off: np.ndarray, *,
                  n_sm: int = N_SM,
                  max_active: "Callable[[int, int], int] | None" = None,
                  cluster: int | None = None) -> MegaGeometry:
    """The cluster size and the shared memory of a batch.

    ``red_off`` [R, S + 2] and ``pool_off`` [R, NSW + 1] are the runs'
    CSR offsets (host arrays).  The cluster starts at ``cluster_size``
    and shrinks while ``max_active(c, smem_bytes)`` (the clusters the
    card holds at once; None: all of them) is below R, so every run is
    resident in one wave.  Rank i owns flows, wires (each with its V
    queues) and switches ``slices(n, c)[i:i + 2]``.  Within
    ``MEGA_SMEM_CAP``, in this order: the channel rows of its queues are
    pushed into its shared memory (else gathered from global memory),
    then its flows' paths are staged (else read there).
    ``cluster`` forces c (1..``MEGA_MAX_CLUSTER``) and skips the check."""
    S = L * V
    red_off = np.asarray(red_off, np.int64).reshape(R, S + 2)
    pool_off = np.asarray(pool_off, np.int64).reshape(R, NSW + 1)
    cap_words = MEGA_SMEM_CAP // 4
    if cluster is not None and not 1 <= cluster <= MEGA_MAX_CLUSTER:
        raise ValueError(f"use_kernels='mega': cluster {cluster} outside "
                         f"1..{MEGA_MAX_CLUSTER} (MEGA_MAX_CLUSTER)")
    c = cluster or cluster_size(R, F, n_sm)
    while True:
        fl, ls, ws = slices(F, c), slices(L, c), slices(NSW, c)
        qs = np.asarray(ls) * V
        flow_cap = max(b - a for a, b in zip(fl, fl[1:]))
        q_cap = V * max(b - a for a, b in zip(ls, ls[1:]))
        rows_cap = int((red_off[:, qs[1:]] - red_off[:, qs[:-1]]).max(
            initial=0))
        pool_cap = int((pool_off[:, ws[1:]] - pool_off[:, ws[:-1]]).max(
            initial=0))
        kw = dict(S=S, L=L, NSW=NSW, V=V, K=K, H=H, q_cap=q_cap,
                  flow_cap=flow_cap, rows_cap=rows_cap, pool_cap=pool_cap)

        def fits(**flags):
            return bool(smem_words(**kw, **flags) <= cap_words)

        push = fits(push_rows=True, stage_paths=False)
        paths = fits(push_rows=push, stage_paths=True)
        words = smem_words(**kw, push_rows=push, stage_paths=paths)
        if words > cap_words:
            raise ValueError(
                f"use_kernels='mega': {words * 4} B of shared memory a CTA "
                f"over MEGA_SMEM_CAP ({MEGA_SMEM_CAP} B)")
        geo = MegaGeometry(cluster=c, q_cap=int(q_cap), flow_cap=flow_cap,
                           rows_cap=rows_cap, pool_cap=pool_cap,
                           push_rows=push, stage_paths=paths,
                           smem_bytes=4 * words)
        if c == 1 or cluster or max_active is None or \
                max_active(c, 4 * words) >= R:
            return geo
        c -= 1


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


def row_positions(red_perm: torch.Tensor, red_off: torch.Tensor, L: int,
                  V: int, c: int) -> torch.Tensor:
    """Where each (flow, candidate, hop) row of every run goes in the
    pushed rows: ``owner << 24 | index`` among the owner's rows, owner
    the cluster rank whose queue slice holds the row's queue; -1 for the
    rows of the scratch queue S (PAD hops).  [R, F*K*H] int32."""
    R, N = red_perm.shape
    S = L * V
    dev = red_perm.device
    pos = torch.empty_like(red_perm)
    pos.scatter_(1, red_perm, torch.arange(N, device=dev).expand(R, N))
    starts = red_off[:, [q * V for q in slices(L, c)]]        # [R, c + 1]
    owner = torch.searchsorted(starts[:, 1:c].contiguous(), pos,
                               right=True) if c > 1 else torch.zeros_like(pos)
    local = pos - torch.gather(starts, 1, owner)
    packed = owner * (1 << 24) + local
    return torch.where(pos < red_off[:, S:S + 1], packed, -1).to(
        torch.int32)


class MegaTables(NamedTuple):
    """The structural half of a ``MegaPlan``: the batch's int32 tables
    and launch geometry, which depend on its scenarios alone
    (``mega_tables``)."""

    path_q: torch.Tensor      # [R, F, K, H] int32 queue of each hop (S: PAD)
    path_n: torch.Tensor      # [R, F, K] int32 hop count
    path_pos: torch.Tensor    # [R, F, K, H] int32 row's owner and place
    red_rows: torch.Tensor    # [R, F*K*H] int32 ScenarioDev.red_perm
    pool_rows: torch.Tensor   # [R, L] int32 ScenarioDev.pool_perm
    geometry: MegaGeometry


class MegaPlan(NamedTuple):
    """Per-run parameter rows, int32 tables and the launch geometry of
    one batch, packed once: ``mega_rows`` then ``MegaTables``."""

    frow: torch.Tensor        # [R, n_float_row()] f32
    irow: torch.Tensor        # [R, len(INT_ROW)] int32
    path_q: torch.Tensor
    path_n: torch.Tensor
    path_pos: torch.Tensor
    red_rows: torch.Tensor
    pool_rows: torch.Tensor
    geometry: MegaGeometry


def mega_rows(par, packed_react: dict, dt: torch.Tensor,
              window: float = 0.0) -> tuple[torch.Tensor, torch.Tensor]:
    """``(frow, irow)``: ``StepParams`` (+ the packed reaction rows and
    the trace window length in seconds) packed into the kernel's two
    per-run rows."""
    from ..core import obs
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
    cols += [obs.to_device(packed_react[name], dev).expand(R, n)
             for name, n in REACT_ROWS]
    irow = torch.stack([getattr(par, f).to(torch.int32) for f in INT_ROW],
                       dim=1)
    return torch.cat(cols, dim=1).contiguous(), irow.contiguous()


def mega_tables(sd, plan, *, cluster: int | None = None) -> MegaTables:
    """The batch ``sd``'s paths and incidence rows as int32 tables, and
    the launch geometry chosen from its CSR offsets (``plan`` is its
    ``ReducePlan``, for ``pool_off``).  On a card the geometry's cluster
    is held to what the card keeps resident at once (``cluster`` forces
    it, see ``mega_geometry``)."""
    from ..core import obs
    R, F, K, H = sd.alt_routes.shape
    dev = sd.alt_routes.device
    L = sd.cap_ext.shape[1] - 1
    S = sd.red_off.shape[1] - 2
    V = S // L if L else 1
    NSW = plan.pool_off.shape[1] - 1
    rt = sd.alt_routes
    q = rt if V == 1 else rt * V + sd.vc
    path_q = torch.where(rt != -1, q, S).to(torch.int32).contiguous()
    max_active = None
    n_sm = N_SM
    if dev.type == "cuda":
        lib = _lib()
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        max_active = lib.fs_max_clusters
    geo = mega_geometry(R, F, K, H, L, V, NSW, obs.to_host(sd.red_off).numpy(),
                        obs.to_host(plan.pool_off).numpy(), n_sm=n_sm,
                        max_active=max_active, cluster=cluster)
    return MegaTables(path_q=path_q,
                      path_n=sd.alt_hops.to(torch.int32).contiguous(),
                      path_pos=row_positions(sd.red_perm, sd.red_off, L, V,
                                             geo.cluster).reshape(
                                                 rt.shape).contiguous(),
                      red_rows=sd.red_perm.to(torch.int32).contiguous(),
                      pool_rows=sd.pool_perm.to(torch.int32).contiguous(),
                      geometry=geo)


def mega_plan(par, packed_react: dict, dt: torch.Tensor,
              window: float = 0.0, *, sd, plan,
              cluster: int | None = None) -> MegaPlan:
    """``mega_rows`` and ``mega_tables`` of one batch as its
    ``MegaPlan``."""
    return MegaPlan(*mega_rows(par, packed_react, dt, window),
                    *mega_tables(sd, plan, cluster=cluster))


def phase_timers_on() -> None:
    """The megakernel's phase timers on the current card: accumulators
    reset (ordered on the current stream), and its launches from now, and
    the graphs captured meanwhile, run the kernel's timed instance."""
    lib = _lib()
    if lib.fs_phase_marks() != len(PHASES):
        raise RuntimeError("fluid_step: PHASES and csrc/fluid_step.cu "
                           "differ in their number of marks")
    _check_err("phase_timers", lib.fs_phase_timers(
        1, 1, torch.cuda.current_stream().cuda_stream))


def phase_timers_off() -> None:
    """Launches from now run the untimed kernel (a graph captured with the
    timers on still runs the timed one)."""
    _check_err("phase_timers", _lib().fs_phase_timers(
        0, 0, torch.cuda.current_stream().cuda_stream))


def read_phase_timers() -> dict:
    """The timers' accumulators, once the current stream's work is done:
    ``loop_ns`` and ``loop_cycles`` (the step loops of run 0's first CTA,
    summed over the timed launches), ``loops`` (those launches) and
    ``phases``: one ``{slot, barrier, phase, cycles, n}`` a mark (``PHASES``),
    ``cycles`` over the ``n`` intervals that ended there."""
    n = len(PHASES)
    cycles, counts, loop = (np.zeros(k, np.uint64) for k in (n, n, 3))
    _check_err("phase_timers", _lib().fs_phase_read(
        cycles.ctypes.data, counts.ctypes.data, loop.ctypes.data,
        torch.cuda.current_stream().cuda_stream))
    return {"loop_ns": int(loop[0]), "loop_cycles": int(loop[1]),
            "loops": int(loop[2]),
            "phases": [{"slot": k, "barrier": b, "phase": ph,
                        "cycles": int(cycles[k]), "n": int(counts[k])}
                       for k, (b, ph) in enumerate(PHASES)]}


@contextlib.contextmanager
def phase_timers():
    """``with phase_timers() as out:`` — the timers on for the block
    (``phase_timers_on``); at exit ``out`` holds ``read_phase_timers()``
    and the timers are off."""
    phase_timers_on()
    out: dict = {}
    try:
        yield out
        out.update(read_phase_timers())
    finally:
        phase_timers_off()


def _check_err(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: {_lib().fs_error_string(err).decode()} "
                           f"({err})")


def _state_leaves(st):
    return [st.cc[n] if n in CC_LEAVES else getattr(st, n)
            for n in STATE_LEAVES]


def _launch(name: str, st, sd, plan, mplan: MegaPlan, *, n_switches: int,
            n_vcs: int, n_substeps: int, block: bool):
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
        "jitter", "sink_ext", "rtt", "red_off")}
    geo = mplan.geometry
    args = MegaArgs(
        R=R, F=F, H=H, K=K, L=L, V=V, S=L * V, D=D, NSW=int(n_switches),
        n_substeps=int(n_substeps), block=int(block),
        nfp=mplan.frow.shape[1], nip=mplan.irow.shape[1],
        cluster=geo.cluster, q_cap=geo.q_cap, flow_cap=geo.flow_cap,
        rows_cap=geo.rows_cap, pool_cap=geo.pool_cap,
        stage_paths=int(geo.stage_paths),
        fpar=mplan.frow.data_ptr(), ipar=mplan.irow.data_ptr(),
        path_q=mplan.path_q.data_ptr(), path_n=mplan.path_n.data_ptr(),
        red_rows=mplan.red_rows.data_ptr(),
        path_pos=mplan.path_pos.data_ptr(), push_rows=int(geo.push_rows),
        pool_rows=mplan.pool_rows.data_ptr(),
        pool_off=plan.pool_off.data_ptr(),
        st_in=(_P * _N)(*[x.data_ptr() for x in ins]),
        st_out=(_P * _N)(*[x.data_ptr() for x in outs]),
        scratch=scratch.data_ptr(),
        **{k: v.data_ptr() for k, v in scn.items()},
        **{f"tr_{k}": v.data_ptr() for k, v in tr.items()})
    lib = _lib()
    err = lib.fs_mega(ctypes.byref(args), geo.smem_bytes,
                      torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed: "
                           f"{lib.fs_error_string(err).decode()} ({err})")
    LAUNCHES[name] += 1
    GEOMETRY[name] = geo
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
    _check(st, sd, n_switches, n_vcs)
    if st.nicq.device.type == "cpu":
        return body(st)
    if st.nicq.device.type != "cuda":
        raise ValueError(f"megastep: no kernel or plain version for device "
                         f"{st.nicq.device}")
    from ..core.fluid import StepTrace
    new, tr = _launch("megastep", st, sd, plan, mplan, n_switches=n_switches,
                      n_vcs=n_vcs, n_substeps=1, block=False)
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
    _check(st, sd, n_switches, n_vcs)
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
                      n_substeps=n_substeps, block=True)
    return new, TraceSample(delivered=new.delivered, rate=new.rate, **tr)
