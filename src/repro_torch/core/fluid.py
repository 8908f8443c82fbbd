"""Dense fluid model of the CC closed loop (port of ``repro.core.fluid``).

The whole network is a fixed-shape state advanced by one branch-free
update per ``dt``.  The port writes that update with an explicit leading
run axis: every tensor of ``ScenarioDev`` / ``StepParams`` /
``FluidState`` is ``[R, ...]``, so a Sweep batch of R runs advances in
one pass and each per-flow kernel takes the whole batch in one launch.

Per step (Jacobi, from pre-step state), as in the reference:
  0. path selection (min / valiant / ugal) at epoch flows;
  1. generation into nicq (``kernels.cc_step.gen_np_step``);
  2. transfers: proportional share of each wire, gated by PFC pause and
     scaled by the strict-FIFO head-of-line factor;
  3. PFC xoff/xon hysteresis per (wire, VC) queue + shared switch pool;
  4. marking, 5. notification (delay line), 6. reaction — one
     registered ``cc`` stage per family, selected per run by code.

Order of sums.  The reference is bit-identical across its reduction
engines because every per-queue sum adds the queue's contributors in
incidence order.  The port keeps that order everywhere:
  * ``reduce="fused"`` with ``dense_rows > 0`` (the dense-CSR walk):
    gathers into a ``[rows, R, S]`` table, then one add per row, left
    to right — deterministic on CPU and CUDA alike;
  * ``reduce="fused"`` with ``dense_rows == 0`` (segment sum) and
    ``reduce="pallas"``: the ``kernels.fluid_reduce.segment_reduce``
    kernel on CUDA (one thread per queue and channel walking its
    contributors in order); on the CPU ``"pallas"`` runs that kernel's
    plain version and the segment sum ``index_add_``, which is ordered
    there;
  * ``reduce="scat"``: ``index_add_`` per quantity, on the CPU only (it
    is atomic and unordered on CUDA, so it raises there);
  * small per-flow sums over hops are sequential adds, as XLA does.

``use_kernels="mega"`` runs the whole step as ONE launch of the
``kernels.fluid_step`` megakernel on CUDA (its plain version, on the
CPU, is ``_step_body`` itself), summing in the same orders.

Soft relaxation (``repro_torch.tune``): ``_step_body(..., tau=...)``
with the batch's per-run ``StepParams.temperature`` runs the reference's
temperature-smoothed step, every softened site written
``soft.select(tau, soft_expr, hard_expr)`` with the hard code verbatim;
``tau=None`` (a hard batch) builds exactly the hard step.  Whether a
batch is soft is a static choice of the caller (``is_soft``), so a
captured window never bakes in a branch on the temperature's value.
The kernel tiers (``use_kernels`` True / "mega") compute the hard step
only and refuse a positive temperature.

Layering:
  * ``Scenario``     — host-side numpy tensors describing one workload
                       (copied verbatim from the reference).
  * ``ScenarioDev``  — the batched device tensors ``fluid_step`` reads.
  * ``StepParams``   — every config scalar, one value per run.
  * ``ReducePlan``   — the static gather tables of the ordered sums.
  * ``fluid_step``   — the per-``dt`` update.
"""

from __future__ import annotations

import collections
import hashlib
import threading
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import fluid_step as mega
from ..kernels.cc_step import gen_np_step
from ..kernels.fluid_reduce import (ReduceSchedule, reduce_schedule,
                                    segment_reduce)
from ..tune import soft
from . import cc, obs
from .params import CCConfig, CCSpec, ROUTING_MODES
from .routing import PAD, link_incidence


class Scenario(NamedTuple):
    """Static per-run tensors (host numpy; moved to device once)."""

    routes: np.ndarray        # [F, H] int32 link ids, PAD = -1
    hops: np.ndarray          # [F] int32
    gen_rate: np.ndarray      # [F] f32 B/s offered by the generator
    t_start: np.ndarray       # [F] f32 s
    t_stop: np.ndarray        # [F] f32 s (generator closes)
    volume: np.ndarray        # [F] f32 B total work (inf = window-limited)
    capacity: np.ndarray      # [L] f32 B/s per directed link
    sink_switch: np.ndarray   # [L] int32 (-1 for host sinks)
    n_switches: int
    rtt_steps: np.ndarray     # [F] int32 CNP feedback delay in dt steps
    nic_buffer: "float | np.ndarray" = 4e6
    alt_routes: "np.ndarray | None" = None    # [F, K, H] int32, PAD-padded
    alt_hops: "np.ndarray | None" = None      # [F, K] int32 (0 = no path)
    vc: "np.ndarray | None" = None            # [F, K, H] int32
    victim: "np.ndarray | None" = None        # [F] bool


class ScenarioDev(NamedTuple):
    """Device-side scenario with a leading run axis (integer fields are
    int64, the index type of torch's gathers)."""

    gen_rate: torch.Tensor    # [R, F] f32
    t_start: torch.Tensor     # [R, F] f32
    t_stop: torch.Tensor      # [R, F] f32
    volume: torch.Tensor      # [R, F] f32
    cap_ext: torch.Tensor     # [R, L+1] f32 (scratch slot L for PAD)
    sink_ext: torch.Tensor    # [R, L+1] int64
    rtt: torch.Tensor         # [R, F] int64
    nic_buffer: torch.Tensor  # [R, F] f32
    alt_routes: torch.Tensor  # [R, F, K, H] int64
    alt_hops: torch.Tensor    # [R, F, K] int64
    vc: torch.Tensor          # [R, F, K, H] int64 in [0, n_vcs)
    jitter: torch.Tensor      # [R, F] f32
    red_perm: torch.Tensor    # [R, F*K*H] int64
    red_seg: torch.Tensor     # [R, F*K*H] int64
    red_off: torch.Tensor     # [R, S+2] int64
    pool_perm: torch.Tensor   # [R, L] int64
    pool_seg: torch.Tensor    # [R, L] int64


class StepParams(NamedTuple):
    """Per-run CC constants, one value per run ([R])."""

    mark_code: torch.Tensor   # [R] int32 — cc.MARKING entry
    notif_code: torch.Tensor  # [R] int32 — cc.NOTIFICATION entry
    react_code: torch.Tensor  # [R] int32 — cc.REACTION entry
    route_code: torch.Tensor  # [R] int32 — 0 min / 1 valiant / 2 ugal
    line_rate: torch.Tensor   # [R] f32
    xoff: torch.Tensor
    xon: torch.Tensor
    pool_xoff: torch.Tensor
    port_buffer: torch.Tensor
    ecp_beta: torch.Tensor
    mark: dict                # marking-family param union ([R] each)
    notif: dict
    react: dict
    temperature: torch.Tensor  # [R] f32 — soft-relaxation temperature
    #                            (read only by a soft batch's step)


class FluidState(NamedTuple):
    qh: torch.Tensor          # [R, F, H] bytes at hop queues
    nicq: torch.Tensor        # [R, F]
    delivered: torch.Tensor   # [R, F]
    offered: torch.Tensor     # [R, F]
    dropped: torch.Tensor     # [R, F]
    est: torch.Tensor         # [R, F, H] EWMA crossing rate per wire
    paused: torch.Tensor      # [R, L * n_vcs] f32 (exact 0/1)
    rate: torch.Tensor        # [R, F]
    rp_target: torch.Tensor
    alpha: torch.Tensor
    byte_cnt: torch.Tensor
    tmr: torch.Tensor
    alpha_tmr: torch.Tensor
    bc_stage: torch.Tensor    # [R, F] int32
    t_stage: torch.Tensor     # [R, F] int32
    hold: torch.Tensor
    np_tmr: torch.Tensor
    trig_buf: torch.Tensor    # [R, D, F] CNP in flight (delay line)
    tgt_buf: torch.Tensor     # [R, D, F] severity payload in flight
    path_idx: torch.Tensor    # [R, F] int32
    cc: dict                  # per-stage state, [R, F] each
    t: torch.Tensor           # [R] int32 step counter


class StepTrace(NamedTuple):
    delivered: torch.Tensor   # [R, F] cumulative bytes
    rate: torch.Tensor        # [R, F]
    inst_thr: torch.Tensor    # [R, F] delivery rate this step (B/s)
    max_q: torch.Tensor       # [R] hottest queue (bytes)
    n_paused: torch.Tensor    # [R] int32 paused queues
    marked: torch.Tensor      # [R, F] bool
    cnp: torch.Tensor         # [R, F] bool
    n_nonmin: torch.Tensor    # [R] int32
    ctrl: torch.Tensor        # [R, F] f32 notifications emitted
    pause_time: torch.Tensor  # [R] f32 wire-seconds paused this step
    vc_stall: torch.Tensor    # [R, V] f32


class ReducePlan(NamedTuple):
    """Static gather tables of the ordered sums (built once per batch).

    ``dense_src[p, r, q]`` is the flattened ``[R*F*K*H]`` row that
    position p of run r's queue q reads (sentinel ``R*F*K*H`` = a zero
    row); ``pool_src`` is the same for the per-switch pool sum over
    ``[R*L]`` link rows.  The segment-sum engines walk the CSR
    ``seg_rows``/``seg_off`` over the R*S real queues (segment ``r*S +
    q``; the scratch queue, which only ever holds zeros, is left out);
    past ``seg_off[-1]`` the walk lists the scratch rows, which no
    segment reads, so its length is structural (R*F*K*H); ``seg_ids`` is
    each walk entry's segment (R*S for that tail); ``seg_sched`` the
    ``segment_reduce`` kernel's work items over that CSR, shared by every
    walk of the step.  ``pool_off`` is the per-run CSR of the pool over
    ``ScenarioDev.pool_perm``.
    """

    dense_src: "torch.Tensor | None"   # [rows, R, S] int64
    pool_src: torch.Tensor             # [rows_pool, R, n_switches] int64
    seg_rows: torch.Tensor             # [R*F*K*H] int64 rows, walk order
    seg_ids: torch.Tensor              # [R*F*K*H] int64 segment r*S + q
    seg_off: torch.Tensor              # [R*S + 1] int64 CSR offsets
    seg_sched: ReduceSchedule          # the kernel's work items
    pool_off: torch.Tensor             # [R, n_switches + 1] int64
    dt: torch.Tensor                   # [] f32


def delay_depth(scn: Scenario) -> int:
    """Delay-line depth covering every flow's CNP feedback delay."""
    return max(2, int(np.max(scn.rtt_steps)) + 1)


def _check_delay(scn: Scenario, delay_slots: int) -> int:
    max_rtt = int(np.max(scn.rtt_steps))
    if max_rtt >= delay_slots:
        raise ValueError(
            f"rtt_steps up to {max_rtt} overflow the {delay_slots}-slot "
            f"delay line; pass delay_slots >= {max_rtt + 1} (or None to "
            f"size it from the scenario)")
    return delay_slots


def _flow_jitter(n: int) -> np.ndarray:
    """Deterministic per-flow jitter in [-1, 1] (Weyl sequence)."""
    x = (np.arange(n, dtype=np.uint64) * np.uint64(2654435761)) % np.uint64(2**32)
    return (x.astype(np.float64) / 2**31 - 1.0).astype(np.float32)


def _digest(x: np.ndarray) -> tuple:
    x = np.ascontiguousarray(x)
    obs.count("digest_bytes", x.nbytes)
    return (x.shape, x.dtype.str, hashlib.sha1(x.tobytes()).hexdigest())


_MEMO_LOCK = threading.Lock()


def _lru_get(cache: collections.OrderedDict, key):
    """``cache[key]``, made the newest entry (None: no such entry)."""
    with _MEMO_LOCK:
        hit = cache.get(key)
        if hit is not None:
            cache.move_to_end(key)
        return hit


def _lru_put(cache: collections.OrderedDict, maxsize: int, key, value):
    """Store ``value`` under ``key`` unless a value is there already,
    which wins and is returned; the oldest entries past ``maxsize`` go."""
    with _MEMO_LOCK:
        value = cache.setdefault(key, value)
        cache.move_to_end(key)
        while len(cache) > maxsize:
            cache.popitem(last=False)
    return value


def _memo_lru(cache: collections.OrderedDict, maxsize: int, key, fn):
    """Bounded content-keyed LRU for the host-side incidence cache and
    the upload cache; safe from several threads (``fn`` runs outside the
    lock: two threads may both compute a value, the first stored wins)."""
    hit = _lru_get(cache, key)
    return hit if hit is not None else _lru_put(cache, maxsize, key, fn())


_INC_CACHE: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()
_INC_CACHE_SIZE = 128


def _incidence(alt_routes: np.ndarray, n_links: int,
               vc: np.ndarray | None = None, n_vcs: int = 1):
    """``link_incidence`` memoised on route-stack content."""
    key = _digest(alt_routes) + (n_links, n_vcs)
    if n_vcs > 1 and vc is not None:
        key = key + _digest(vc)
    return _memo_lru(_INC_CACHE, _INC_CACHE_SIZE, key,
                     lambda: link_incidence(alt_routes, n_links,
                                            vc=vc, n_vcs=n_vcs))


def _pool_incidence(sink_switch: np.ndarray, n_switches: int):
    """Link ids stably sorted by sink switch (-1 hosts -> scratch)."""
    seg = np.where(sink_switch >= 0, sink_switch, n_switches)
    perm = np.argsort(seg, kind="stable").astype(np.int32)
    return perm, seg[perm].astype(np.int32)


#: Longest per-link contributor list the dense reduction will tile; more
#: skewed scenarios fall back to the sorted segment-sum engine.
DENSE_ROWS_CAP = 1024


def clamp_dense_rows(ml: int, n_links: int, n_entries: int) -> int:
    """Apply the dense-CSR size guard to a row count (0 = disable)."""
    if ml == 0 or ml > DENSE_ROWS_CAP:
        return 0
    if n_links * ml > max(16 * n_entries, 1 << 20):
        return 0
    return ml


def _scenario_vc(scn: Scenario, alt_routes: np.ndarray,
                 n_vcs: int) -> np.ndarray:
    """Validated [F, K, H] VC tensor for a scenario (all-zero default)."""
    if n_vcs == 1 or scn.vc is None:
        return np.zeros(alt_routes.shape, np.int32)
    vc = np.asarray(scn.vc, np.int32)
    if vc.shape != alt_routes.shape:
        raise ValueError(
            f"Scenario.vc shape {vc.shape} != candidate stack shape "
            f"{alt_routes.shape}")
    if vc.min(initial=0) < 0 or vc.max(initial=0) >= n_vcs:
        raise ValueError(
            f"Scenario.vc entries must lie in [0, {n_vcs}) "
            f"(got [{vc.min()}, {vc.max()}]); rebuild the assignment "
            f"for this n_vcs (routing.assign_vc clips for you)")
    return np.where(alt_routes == PAD, 0, vc).astype(np.int32)


def dense_reduce_rows(scn: Scenario, n_vcs: int = 1) -> int:
    """Static row count for the dense-CSR fused reduction (0 = disable):
    the most contributors any (wire, VC) queue has, clamped."""
    alt = scn.routes[:, None, :] if scn.alt_routes is None \
        else scn.alt_routes
    alt = np.asarray(alt, np.int32)
    L = scn.capacity.shape[0]
    if L == 0:
        return 0
    vc = _scenario_vc(scn, alt, n_vcs)
    S = L * n_vcs
    _, _, off = _incidence(alt, L, vc, n_vcs)
    ml = int(np.max(off[1:S + 1] - off[:S]))
    return clamp_dense_rows(ml, S, alt.size)


def check_routing_paths(cfg: "CCConfig | CCSpec", scn: Scenario) -> None:
    """Adaptive routing needs detour candidates to select from."""
    K = 1 if scn.alt_routes is None else scn.alt_routes.shape[1]
    if cfg.routing != "min" and K == 1:
        raise ValueError(
            f"routing={cfg.routing!r} needs a multi-path scenario with "
            f"detour candidates (build it with ScenarioSpec(n_paths > 1) "
            f"or Scenario.alt_routes); this scenario is single-path")


def kernel_tier(use_kernels) -> str:
    """Normalise ``use_kernels``: False -> "off", True -> "flow",
    "mega" -> the whole-step megakernel (``kernels.fluid_step``).

    In the port "off" and "flow" run the same path: the per-flow stages
    always go through ``kernels.cc_step``, which launches its CUDA
    kernels on a CUDA device and runs their plain versions on the CPU.
    """
    if use_kernels is False or use_kernels is None:
        return "off"
    if use_kernels is True:
        return "flow"
    if use_kernels in ("off", "flow", "mega"):
        return use_kernels
    raise ValueError(
        f"use_kernels must be False, True or 'mega' "
        f"(or the tier names 'off'/'flow'), got {use_kernels!r}")


def is_soft(temperature) -> bool:
    """Whether a batch runs the soft model: any run's temperature > 0
    (a python number, or a tensor, read back once on the host)."""
    if isinstance(temperature, torch.Tensor):
        return bool(temperature.numel()) and float(temperature.max()) > 0.0
    return float(temperature) > 0.0


def refuse_unported(*, reduce: str = "fused", use_kernels=False,
                    temperature=0.0) -> None:
    """Raise for option values and combinations the port refuses."""
    if reduce not in ("fused", "pallas", "scat"):
        raise ValueError(
            f"reduce must be 'fused', 'pallas' or 'scat', got {reduce!r}")
    if kernel_tier(use_kernels) == "mega" and reduce == "pallas":
        raise ValueError(
            "use_kernels='mega' runs the link sums inside its launch; "
            "reduce must be 'fused' or 'scat' (the segment_reduce kernel "
            "does not nest in the megakernel)")
    if kernel_tier(use_kernels) != "off" and is_soft(temperature):
        raise ValueError(
            "temperature > 0 needs use_kernels=False: the kernel tiers "
            "implement the hard dynamics only (use_kernels=False runs the "
            "soft sites beside the per-flow kernels, which compute the "
            "hard branch)")


def resolve_device(device=None) -> torch.device:
    """``None`` -> the card; raises when there is none (the port never
    falls back to the CPU on its own)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; the port runs on the GPU by "
                "default — pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# ---------------------------------------------------------------------------
# host -> device
# ---------------------------------------------------------------------------


def scenario_arrays(scn: Scenario, n_vcs: int = 1) -> dict:
    """The numpy fields of one (unbatched) ``ScenarioDev``."""
    if scn.alt_routes is None:          # single-path: K = 1 mirror
        alt_routes = scn.routes[:, None, :]
        alt_hops = scn.hops[:, None]
    else:
        alt_routes, alt_hops = scn.alt_routes, scn.alt_hops
    alt_routes = np.asarray(alt_routes, np.int32)
    F = scn.routes.shape[0]
    L = scn.capacity.shape[0]
    vc = _scenario_vc(scn, alt_routes, n_vcs)
    perm, seg, off = _incidence(alt_routes, L, vc, n_vcs)
    pool_perm, pool_seg = _pool_incidence(
        np.asarray(scn.sink_switch, np.int32), int(scn.n_switches))
    return dict(
        gen_rate=np.asarray(scn.gen_rate, np.float32),
        t_start=np.asarray(scn.t_start, np.float32),
        t_stop=np.asarray(scn.t_stop, np.float32),
        volume=np.asarray(scn.volume, np.float32),
        cap_ext=np.concatenate([scn.capacity, [np.inf]]).astype(np.float32),
        sink_ext=np.concatenate([scn.sink_switch, [-1]]).astype(np.int64),
        rtt=np.asarray(scn.rtt_steps, np.int64),
        nic_buffer=np.broadcast_to(
            np.asarray(scn.nic_buffer, np.float32), (F,)).copy(),
        alt_routes=alt_routes.astype(np.int64),
        alt_hops=np.asarray(alt_hops, np.int64),
        vc=vc.astype(np.int64),
        jitter=_flow_jitter(F),
        red_perm=perm.astype(np.int64), red_seg=seg.astype(np.int64),
        red_off=off.astype(np.int64),
        pool_perm=pool_perm.astype(np.int64),
        pool_seg=pool_seg.astype(np.int64))


# Content-keyed device-placement cache (the reference's ``_cached_put``).
# A sweep's grid points mostly share a FabricSpec, and a repeated batch
# structure stacks the same routes, capacities and incidence again:
# hashing is cheaper than uploading them anew.  Keys carry shape, dtype,
# digest and device, so two different tensors never alias.  Bounded LRU:
# a long-lived process sweeping many fabrics cannot leak device memory.
# The cached tensors are shared by every batch that stacks the same
# content, so nothing may write into them (the sweep's window runners
# copy them into tensors of their own).
_PUT_CACHE: "collections.OrderedDict[tuple, torch.Tensor]" = \
    collections.OrderedDict()
_PUT_CACHE_SIZE = 256
#: the ``ScenarioDev`` fields the reference places through the cache
_PUT_FIELDS = ("alt_routes", "alt_hops", "vc", "cap_ext", "sink_ext",
               "jitter", "red_perm", "red_seg", "red_off", "pool_perm",
               "pool_seg")


def _cached_put(x: np.ndarray, device: torch.device) -> torch.Tensor:
    x = np.ascontiguousarray(x)
    missed = []

    def put():
        missed.append(True)
        return obs.to_device(torch.from_numpy(x), device)

    out = _memo_lru(_PUT_CACHE, _PUT_CACHE_SIZE, _digest(x) + (device,),
                    put)
    if not missed:
        obs.count("put_hit_bytes", x.nbytes)
    return out


def _upload(cls, arrays: list[dict], device):
    """Stack per-run numpy dicts into one batched NamedTuple on device
    (``_PUT_FIELDS`` through the content-keyed cache)."""
    def put(f):
        x = np.stack([a[f] for a in arrays])
        if f in _PUT_FIELDS:
            return _cached_put(x, device)
        return obs.to_device(torch.from_numpy(x), device)
    return cls(**{f: put(f) for f in cls._fields})


def scenario_device(scn: Scenario, n_vcs: int = 1, *,
                    device=None) -> ScenarioDev:
    """One scenario as a batched ``ScenarioDev`` with R = 1
    (``device=None`` is the card)."""
    return _upload(ScenarioDev, [scenario_arrays(scn, n_vcs)],
                   resolve_device(device))


def _step_params_one(cfg: "CCConfig | CCSpec", *,
                    temperature: float = 0.0) -> dict:
    """One config's ``StepParams`` fields as 0-d CPU tensors (and the
    three family dicts); ``step_params`` stacks these."""
    spec: CCSpec = cfg.to_spec()
    lk = spec.link
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)   # noqa: E731
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)     # noqa: E731
    return dict(
        mark_code=i32(cc.MARKING.code(spec.marking)),
        notif_code=i32(cc.NOTIFICATION.code(spec.notification)),
        react_code=i32(cc.REACTION.code(spec.reaction)),
        route_code=i32(ROUTING_MODES.index(spec.routing)),
        line_rate=f32(lk.line_rate),
        xoff=f32(lk.port_buffer * lk.pfc_xoff_frac),
        xon=f32(lk.port_buffer * lk.pfc_xon_frac),
        pool_xoff=f32(lk.shared_buffer * lk.pfc_xoff_frac),
        port_buffer=f32(lk.port_buffer),
        ecp_beta=f32(spec.rev.ecp_rate_ewma),
        mark=cc.MARKING.device_params(spec),
        notif=cc.NOTIFICATION.device_params(spec),
        react=cc.REACTION.device_params(spec),
        temperature=f32(temperature))


def step_params(cfgs, *, temperature: float = 0.0,
                device=None) -> StepParams:
    """Stack the configs' constants into a batched ``StepParams`` (one
    config, or a sequence of them; ``device=None`` is the card)."""
    device = resolve_device(device)
    if isinstance(cfgs, (CCConfig, CCSpec)):
        cfgs = [cfgs]
    ones = [_step_params_one(c, temperature=temperature) for c in cfgs]
    out = {}
    for f in StepParams._fields:
        if f in ("mark", "notif", "react"):
            out[f] = {k: obs.to_device(torch.stack([o[f][k] for o in ones]),
                                       device)
                      for k in ones[0][f]}
        else:
            out[f] = obs.to_device(torch.stack([o[f] for o in ones]), device)
    return StepParams(**out)


def state_arrays(scn: Scenario, cfg: "CCConfig | CCSpec",
                 delay_slots: int | None = None) -> dict:
    """The numpy fields of one (unbatched) initial ``FluidState``."""
    F, H = scn.routes.shape
    L = scn.capacity.shape[0]
    V = int(getattr(cfg.link, "n_vcs", 1))
    D = delay_depth(scn) if delay_slots is None \
        else _check_delay(scn, delay_slots)
    line = np.minimum(scn.gen_rate, cfg.link.line_rate).astype(np.float32)
    z_f = np.zeros((F,), np.float32)
    return dict(
        qh=np.zeros((F, H), np.float32), nicq=z_f, delivered=z_f,
        offered=z_f, dropped=z_f, est=np.zeros((F, H), np.float32),
        paused=np.zeros((L * V,), np.float32), rate=line, rp_target=line,
        alpha=np.full((F,), cfg.dcqcn.alpha_init, np.float32),
        byte_cnt=z_f, tmr=z_f, alpha_tmr=z_f,
        bc_stage=np.zeros((F,), np.int32), t_stage=np.zeros((F,), np.int32),
        hold=z_f, np_tmr=np.full((F,), 1.0, np.float32),
        trig_buf=np.zeros((D, F), np.float32),
        tgt_buf=np.zeros((D, F), np.float32),
        path_idx=np.zeros((F,), np.int32),
        cc=cc.init_cc_state(scn), t=np.zeros((), np.int32))


def init_state(scns, cfgs, delay_slots: int | None = None, *,
               device=None) -> FluidState:
    """Batched initial state: one scenario and config (R = 1) or equal
    length sequences of them, all padded to one shape (``device=None``
    is the card)."""
    device = resolve_device(device)
    if isinstance(scns, Scenario):
        scns, cfgs = [scns], [cfgs]
    arrs = [state_arrays(s, c, delay_slots) for s, c in zip(scns, cfgs)]
    up = lambda xs: obs.to_device(torch.from_numpy(np.stack(xs)),  # noqa: E731
                                  device)
    return FluidState(**{
        f: ({k: up([a["cc"][k] for a in arrs]) for k in arrs[0]["cc"]}
            if f == "cc" else up([a[f] for a in arrs]))
        for f in FluidState._fields})


def pool_counts(sd: ScenarioDev, n_switches: int) -> np.ndarray:
    """[R, n_switches] links draining into each switch's shared pool."""
    L = sd.cap_ext.shape[1] - 1
    sinks = obs.to_host(sd.sink_ext[:, :L]).numpy()
    return np.stack([np.bincount(sk[sk >= 0], minlength=n_switches)
                     [:n_switches] for sk in sinks])


def reduce_plan(sd: ScenarioDev, *, n_switches: int, n_vcs: int,
                dense_rows: int, dt: float,
                pool_rows: int | None = None) -> ReducePlan:
    """Build the ordered-sum gather tables of a batch (host work, once).

    Runs are flattened by offsetting row ids by ``r*F*K*H`` (and links
    by ``r*L``), so one gather + row-by-row add serves the whole batch
    while each queue still sums its contributors in incidence order.
    ``pool_rows`` floors the pool walk's depth (normally the batch's
    largest switch): a slice of a batch walks as deep as the batch.
    """
    dev = sd.gen_rate.device
    R, F, K, H = sd.alt_routes.shape
    L = sd.cap_ext.shape[1] - 1
    S = L * n_vcs
    N = F * K * H
    perm = obs.to_host(sd.red_perm).numpy()
    seg = obs.to_host(sd.red_seg).numpy()
    off = obs.to_host(sd.red_off).numpy()
    base = (np.arange(R, dtype=np.int64) * N)[:, None]
    dense_src = None
    if dense_rows:
        lens = off[:, 1:S + 1] - off[:, :S]                     # [R, S]
        if lens.max(initial=0) > dense_rows:
            raise ValueError(
                f"dense_rows={dense_rows} cannot cover a queue with "
                f"{int(lens.max())} contributors")
        pos = np.arange(dense_rows, dtype=np.int64)[:, None, None]
        at = np.minimum(off[None, :, :S] + pos, max(N - 1, 0))  # [P, R, S]
        rows = perm[np.arange(R)[None, :, None], at] if N else at
        dense_src = np.where(pos < lens[None], base[None] + rows, R * N)
    # per-switch pool: links stably sorted by sink switch; host-sink
    # links sort after every switch and add exact zeros, so they drop out
    pperm = obs.to_host(sd.pool_perm).numpy()
    counts = pool_counts(sd, n_switches)
    p_rows = max(int(counts.max(initial=0)), int(pool_rows or 0))
    starts = np.concatenate([np.zeros((R, 1), np.int64),
                             np.cumsum(counts, axis=1)[:, :-1]], axis=1)
    ppos = np.arange(p_rows, dtype=np.int64)[:, None, None]
    pat = np.minimum(starts[None] + ppos, max(L - 1, 0))
    prow = pperm[np.arange(R)[None, :, None], pat] if L else pat
    pool_src = np.where(ppos < counts[None],
                        (np.arange(R, dtype=np.int64) * L)[None, :, None]
                        + prow, R * L)
    pool_off = np.concatenate([np.zeros((R, 1), np.int64),
                               np.cumsum(counts, axis=1)], axis=1)
    # segment CSR over the real queues, run after run; then every other
    # row (PAD hops: the scratch queue's zeros), which no segment reads,
    # so the walk is R*F*K*H long whatever the batch holds and batches
    # of one structure share one cached window
    n_real = off[:, S]                                       # [R]
    seg_rows = np.concatenate([r * N + perm[r, :n_real[r]]
                               for r in range(R)]
                              + [r * N + perm[r, n_real[r]:]
                                 for r in range(R)])
    seg_ids = np.concatenate([r * S + seg[r, :n_real[r]]
                              for r in range(R)]
                             + [np.full(R * N - int(n_real.sum()), R * S)])
    walk0 = np.concatenate([[0], np.cumsum(n_real)[:-1]]).astype(np.int64)
    seg_off = np.concatenate([(walk0[:, None] + off[:, :S]).reshape(-1),
                              [int(n_real.sum())]])
    t = lambda x: obs.to_device(                                 # noqa: E731
        torch.from_numpy(np.ascontiguousarray(x, np.int64)), dev)
    sched = reduce_schedule(seg_off)
    return ReducePlan(
        dense_src=None if dense_src is None else t(dense_src),
        pool_src=t(pool_src), seg_rows=t(seg_rows), seg_ids=t(seg_ids),
        seg_off=t(seg_off),
        seg_sched=sched._replace(items=obs.to_device(sched.items, dev),
                                 lanes=obs.to_device(sched.lanes, dev)),
        pool_off=t(pool_off),
        dt=obs.to_device(torch.tensor(dt, dtype=torch.float32), dev))


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-run gather: ``x`` [R, N], ``idx`` [R, ...] -> [R, ...]."""
    return torch.gather(x, 1, idx.reshape(idx.shape[0], -1)) \
        .reshape(idx.shape)


def _seq_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Left-to-right sum over a short axis (XLA's order for the
    reference's small reductions)."""
    parts = x.unbind(dim)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def _ordered_walk(data_ext: torch.Tensor, src: torch.Tensor):
    """``sum_p data_ext[src[p]]`` added row by row from zero (the
    dense-CSR walk); ``src`` [P, ...] -> [...] (+ trailing channels)."""
    dense = torch.index_select(data_ext, 0, src.reshape(-1)).reshape(
        src.shape + data_ext.shape[1:])            # [P, ..., C]
    acc = torch.zeros(dense.shape[1:], dtype=dense.dtype,
                      device=dense.device)
    for p in range(dense.shape[0]):
        acc = acc + dense[p]
    return acc


def _cpu_only(what: str, x: torch.Tensor) -> None:
    if x.device.type != "cpu":
        raise NotImplementedError(
            f"{what} is CPU-only: index_add_ is atomic and unordered on "
            f"CUDA; on the card use reduce='fused' or 'pallas', whose "
            f"segment sums go through the ordered segment_reduce kernel "
            f"(kernels/fluid_reduce.py)")


def fluid_step(st: FluidState, sd: ScenarioDev, par: StepParams,
               plan: ReducePlan | None = None, *, dt: float,
               n_switches: int, reduce: str = "fused", dense_rows: int = 0,
               use_kernels: "bool | str" = False, n_vcs: int = 1,
               packed_react: dict | None = None):
    """One ``dt`` update of every run: (state, scenario, params) ->
    (state, trace).

    ``reduce``: ``"fused"`` (the ordered dense-CSR walk when
    ``dense_rows > 0``, else the segment sum), ``"pallas"`` (the
    ``segment_reduce`` kernel) or ``"scat"`` (the reference's scatter
    baseline, CPU only).  ``use_kernels`` False and True run the same
    path; ``"mega"`` runs the whole step as one ``megastep`` launch on
    the card (see ``kernel_tier``).  ``plan`` and ``packed_react`` are
    built here when not given; callers stepping many times build them
    once (``make_step_fn``, ``Sweep.run``).  When any run's
    ``par.temperature`` is > 0 the step is the soft one (read on the
    host, once a call).
    """
    refuse_unported(reduce=reduce, use_kernels=use_kernels,
                    temperature=par.temperature)
    tau = par.temperature if is_soft(par.temperature) else None
    if plan is None:
        plan = reduce_plan(sd, n_switches=n_switches, n_vcs=n_vcs,
                           dense_rows=dense_rows if reduce == "fused"
                           else 0, dt=dt)
    if packed_react is None:
        packed_react = cc.pack_react_rows(par.react, par.line_rate, plan.dt)

    def body(s):
        return _step_body(s, sd, par, plan, n_switches=n_switches,
                          reduce=reduce, n_vcs=n_vcs,
                          packed_react=packed_react, tau=tau)

    if kernel_tier(use_kernels) == "mega":
        return mega.megastep(st, sd, par, plan,
                             mega.mega_plan(par, packed_react, plan.dt,
                                            sd=sd, plan=plan),
                             body=body, n_switches=n_switches, n_vcs=n_vcs)
    return body(st)


def _step_body(st: FluidState, sd: ScenarioDev, par: StepParams,
               plan: ReducePlan, *, n_switches: int, reduce: str,
               n_vcs: int, packed_react: dict, tau=None,
               stages: tuple | None = None):
    """One step of every run.  ``tau`` ([R] temperatures) makes it the
    soft step; ``None`` builds the hard step alone.  ``stages`` (the
    marking, notification and reaction codes the batch's runs use, as
    three frozensets) evaluates only those stages (``cc.dispatch``'s
    ``only``); ``None`` evaluates every registered one."""
    only = (None, None, None) if stages is None else stages
    fused = reduce != "scat"
    R, F, K, H = sd.alt_routes.shape
    L = sd.cap_ext.shape[1] - 1
    V = int(n_vcs)
    S = L * V                 # (wire, VC) queue count; S == L when V == 1
    D = st.trig_buf.shape[1]
    dev = st.nicq.device
    dt = plan.dt
    f32 = torch.float32
    if not fused:
        _cpu_only("reduce='scat'", st.nicq)
    col = lambda x: x[:, None]                         # noqa: E731

    def to_wire(x_ext):
        """Fold per-queue [R, S + 1] sums to per-wire [R, L + 1]."""
        if V == 1:
            return x_ext
        return torch.cat([_seq_sum(x_ext[:, :S].reshape(R, L, V), 2),
                          x_ext[:, S:]], dim=1)

    arange_h = torch.arange(H, device=dev)[None, None, :]
    fidx = torch.arange(F, device=dev)[None, :]
    t_sec = st.t.to(f32) * dt                          # [R]

    def pick_paths(k_idx):
        """([R, F, H] routes, [R, F] hops) of candidate ``k_idx``."""
        k = k_idx.long()
        r = torch.gather(sd.alt_routes, 2,
                         k[:, :, None, None].expand(R, F, 1, H))[:, :, 0]
        h = torch.gather(sd.alt_hops, 2, k[:, :, None])[:, :, 0]
        return r, h

    def link_sums(channels, k_sel):
        """All per-queue sums of the [R, F, H] ``channels`` in one pass:
        laid out on candidate slot ``k_sel`` (zeros elsewhere), summed
        per queue in incidence order.  Returns [R, S + 1] each."""
        data = torch.stack(channels, dim=-1)           # [R, F, H, C]
        C = data.shape[-1]
        if K > 1:
            onehot = (torch.arange(K, device=dev)[None, None, :]
                      == k_sel[:, :, None].long())     # [R, F, K]
            data = data[:, :, None] * onehot[:, :, :, None, None].to(f32)
        data = data.reshape(R * F * K * H, C)
        if plan.dense_src is not None and reduce == "fused":
            ext = torch.cat([data, data.new_zeros((1, C))])
            acc = _ordered_walk(ext, plan.dense_src)   # [R, S, C]
        elif reduce == "pallas" or data.device.type != "cpu":
            acc = segment_reduce(data, None, R * S, rows=plan.seg_rows,
                                 offsets=plan.seg_off,
                                 schedule=plan.seg_sched).reshape(R, S, C)
        else:                       # CPU segment sum: index_add_ in order
            acc = data.new_zeros((R * S + 1, C)).index_add_(
                0, plan.seg_ids, data[plan.seg_rows])[:R * S] \
                .reshape(R, S, C)   # row R*S: the unread tail of the walk
        # the scratch queue S (PAD hops) only ever sums zeros
        sums = torch.cat([acc, acc.new_zeros((R, 1, C))], dim=1)
        return [sums[:, :, c] for c in range(C)]

    def scat(values, idx, n):
        """Scatter-add [R, F, H] values onto per-run slots [R, n] (CPU,
        in index order)."""
        gidx = (idx + torch.arange(R, device=dev)[:, None, None] * n)
        return values.new_zeros(R * n).index_add_(
            0, gidx.reshape(-1), values.reshape(-1)).reshape(R, n)

    # ---- 0. path selection (min / valiant / ugal) -------------------------
    if K == 1:
        path_idx = st.path_idx
        routes, hops = sd.alt_routes[:, :, 0, :], sd.alt_hops[:, :, 0]
    else:
        routes_old, hops_old = pick_paths(st.path_idx)
        v_old = routes_old != PAD
        hq_old = v_old & (arange_h < (hops_old[:, :, None] - 1))
        q_old = torch.where(hq_old, st.qh, 0.0)
        if fused:
            (B_prev,) = link_sums([q_old], st.path_idx)
            B_prev = to_wire(B_prev)
        elif V == 1:
            B_prev = scat(q_old, torch.where(v_old, routes_old, L), L + 1)
        else:
            vc_old = torch.gather(
                sd.vc, 2, st.path_idx.long()[:, :, None, None]
                .expand(R, F, 1, H))[:, :, 0]
            B_prev = to_wire(scat(
                q_old, torch.where(v_old, routes_old * V + vc_old, S),
                S + 1))

        def path_cost(k_idx):
            """UGAL cost: hop count x backlog along the candidate."""
            r, h = pick_paths(k_idx)
            v = r != PAD
            q = _seq_sum(torch.where(v, _take(B_prev, torch.where(v, r, L)),
                                     0.0), 2)
            return h.to(f32) * q

        n_alt = (sd.alt_hops[:, :, 1:] > 0).sum(dim=2)
        samp = torch.where(
            n_alt > 0, 1 + (fidx + col(st.t)) % torch.clamp_min(n_alt, 1),
            0)
        ugal_pick = torch.where(
            path_cost(samp) < path_cost(torch.zeros_like(samp)), samp, 0)
        ts = col(t_sec)
        starting = (ts >= sd.t_start) & (ts - dt < sd.t_start)
        rslot0 = (st.t % D).long()
        cnp_now = st.trig_buf[torch.arange(R, device=dev), rslot0] > 0
        rc = col(par.route_code)
        epoch = starting | ((rc == 2) & cnp_now)
        pick = torch.where(rc == 1, samp, ugal_pick)
        path_idx = torch.where(rc == 0, 0,
                               torch.where(epoch, pick, st.path_idx)
                               ).to(torch.int32)
        routes, hops = pick_paths(path_idx)

    valid = routes != PAD
    widx = torch.where(valid, routes, L)       # PAD -> scratch slot L
    if V == 1:
        qidx = widx
    else:
        vc_sel = sd.vc[:, :, 0, :] if K == 1 else torch.gather(
            sd.vc, 2, path_idx.long()[:, :, None, None]
            .expand(R, F, 1, H))[:, :, 0]
        qidx = torch.where(valid, widx * V + vc_sel, S)
    hm1 = hops[:, :, None] - 1
    is_last = valid & (arange_h == hm1)
    holds_queue = valid & (arange_h < hm1)
    eps_rate = 1e6                             # B/s: "active" demand

    # ---- 1. generation (+ notification-timer tick) ------------------------
    nicq, offered, dropped, np_tmr_t = gen_np_step(
        st.nicq, st.offered, st.dropped, st.np_tmr, sd.gen_rate,
        sd.t_start, sd.t_stop, sd.volume, sd.nic_buffer, t_sec=t_sec, dt=dt)

    # ---- 2. transfers -----------------------------------------------------
    src_inj = torch.minimum(
        nicq, torch.minimum(st.rate, col(par.line_rate)) * dt)
    src_q = torch.cat([src_inj[:, :, None], st.qh[:, :, :-1]], dim=2)
    src_q = torch.where(valid, src_q, 0.0)

    pause_q = torch.cat([st.paused, st.paused.new_zeros((R, 1))], dim=1)
    wire_open = 1.0 - _take(pause_q, qidx)             # [R, F, H]
    next_open = torch.cat([wire_open[:, :, 1:],
                           wire_open.new_ones((R, F, 1))], dim=2)
    q_here = torch.where(holds_queue, st.qh, 0.0)
    weight = src_q * wire_open
    caps_w = _take(sd.cap_ext, widx)                   # [R, F, H]
    if fused:
        num, den, sum_w = link_sums([q_here * next_open, q_here, weight],
                                    path_idx)
    else:
        num, den, sum_w = (scat(x, qidx, S + 1) for x in
                           (q_here * next_open, q_here, weight))
    fifo_ok = torch.where(den > 0, num / torch.clamp_min(den, 1e-9), 1.0)
    sum_w_w = to_wire(sum_w)

    budget = caps_w * dt * _take(fifo_ok, qidx)
    sww = _take(sum_w_w, widx)
    share = torch.where(sww > 0, budget * weight / torch.clamp_min(sww, 1e-9),
                        0.0)
    T = torch.minimum(weight, share)                   # bytes crossing h

    nicq = nicq - T[:, :, 0]
    qh = st.qh - torch.nn.functional.pad(T[:, :, 1:], (0, 1))
    qh = qh + torch.where(holds_queue, T, 0.0)
    qh = torch.clamp_min(qh, 0.0)
    # one hop per flow is the delivery hop: a sum of one value and zeros
    deliv_step = torch.where(is_last, T, 0.0).sum(dim=2)
    delivered = st.delivered + deliv_step

    beta = par.ecp_beta[:, None, None]
    est = (1 - beta) * st.est + beta * (T / dt)
    dem = torch.cat([est[:, :, :1], est[:, :, :-1]], dim=2)
    dem = torch.where(valid, dem, 0.0)
    act = (dem > eps_rate) & valid

    # ---- 3. PFC -----------------------------------------------------------
    b_here = torch.where(holds_queue, qh, 0.0)
    act_f = act.to(f32)
    dem_act = torch.where(act, dem, 0.0)
    if fused:
        B_ext, n_act, sum_dem = link_sums([b_here, act_f, dem_act], path_idx)
    else:
        B_ext, n_act, sum_dem = (scat(x, qidx, S + 1)
                                 for x in (b_here, act_f, dem_act))
    B = B_ext[:, :S]                                   # [R, S]
    n_act_w = to_wire(n_act)
    sum_dem_w = to_wire(sum_dem)
    if V == 1:
        xoff_q, xon_q = col(par.xoff), col(par.xon)
    else:
        xoff_q, xon_q = col(par.xoff / V), col(par.xon / V)
    paused = torch.where(B > xoff_q, 1.0,
                         torch.where(B < xon_q, 0.0, st.paused))
    if tau is not None:
        # the pause level relaxes toward 1 (0) through a sigmoid band
        # O(tau * port_buffer) wide around each threshold
        pb = col(par.port_buffer)
        g_on = soft.unit_gate(B - xoff_q, col(tau), pb)
        g_off = soft.unit_gate(xon_q - B, col(tau), pb)
        paused = soft.select(
            col(tau), st.paused + (1.0 - st.paused) * g_on
            - st.paused * g_off, paused)
    sink_l = sd.sink_ext[:, :L]
    B_wire = B if V == 1 else _seq_sum(B.reshape(R, L, V), 2)
    pool_in = torch.where(sink_l >= 0, B_wire, 0.0).reshape(-1)
    pool = _ordered_walk(torch.cat([pool_in, pool_in.new_zeros(1)]),
                         plan.pool_src)                # [R, n_switches]
    pool_hot = (pool > col(par.pool_xoff)).to(f32)
    if tau is not None:
        pool_hot = soft.select(
            col(tau), soft.unit_gate(pool - col(par.pool_xoff), col(tau),
                                     col(par.port_buffer)), pool_hot)
    pool_pause = torch.where(sink_l >= 0,
                             _take(pool_hot, torch.clamp_min(sink_l, 0)),
                             0.0)
    if V > 1:
        pool_pause = torch.repeat_interleave(pool_pause, V, dim=1)
    paused = torch.maximum(paused, pool_pause)

    # ---- 4. marking (cc.MARKING dispatch) ---------------------------------
    B1 = torch.cat([B, B.new_zeros((R, 1))], dim=1)
    B1_w = _take(B1, qidx)
    present = (qh > 0) | (T > 0)

    share0 = caps_w / torch.clamp_min(_take(n_act_w, widx), 1.0)
    under = dem < share0
    sur_in = torch.where(act & under, share0 - dem, 0.0)
    heavy_in = (act & ~under).to(f32)
    if fused:
        surplus, n_heavy = link_sums([sur_in, heavy_in], path_idx)
    else:
        surplus, n_heavy = (scat(x, qidx, S + 1) for x in (sur_in, heavy_in))
    surplus_w = to_wire(surplus)
    n_heavy_w = to_wire(n_heavy)
    grant = torch.where(
        under, dem,
        share0 + _take(surplus_w, widx)
        / torch.clamp_min(_take(n_heavy_w, widx), 1.0))
    grant = torch.where(act, grant, caps_w)
    sdw = _take(sum_dem_w, widx)
    oversub = (sdw > caps_w).to(f32)
    if tau is not None:
        # the PAD slot's cap is inf, so the soft gate is exactly 0 there
        tau3 = tau[:, None, None]
        oversub = soft.select(
            tau3, soft.unit_gate(sdw - caps_w, tau3,
                                 par.line_rate[:, None, None]), oversub)
    inf_col = torch.full((R, F, 1), torch.inf, dtype=f32, device=dev)
    grant_next = torch.cat([grant[:, :, 1:], inf_col], dim=2)
    grant_next = torch.where(holds_queue, grant_next, torch.inf)
    zero_col = qh.new_zeros((R, F, 1))
    dem_next = torch.cat([dem[:, :, 1:], zero_col], dim=2)
    over_next = torch.cat([oversub[:, :, 1:], zero_col], dim=2)

    (mark_fh, sev), cc_mark = cc.dispatch(
        cc.MARKING, par.mark_code, par.mark,
        cc.MarkCtx(B1_w=B1_w, present=present, holds_queue=holds_queue,
                   dem_next=dem_next, grant_next=grant_next,
                   over_next=over_next, port_buffer=par.port_buffer,
                   line_rate=par.line_rate, tau=tau),
        st.cc, only=only[0])
    mark_pos = mark_fh > 0.0
    marked = mark_pos.any(dim=2)
    tgt = torch.amin(torch.where(mark_pos, sev, torch.inf), dim=2)
    tgt = torch.where(torch.isfinite(tgt), tgt, col(par.line_rate))
    if tau is not None:
        # intensity-weighted mean severity; inf sentinels take the
        # line-rate fallback inside the mask, never a product
        line3 = par.line_rate[:, None, None]
        sev_fin = torch.where(torch.isfinite(sev), sev, line3)
        m_sev = _seq_sum(torch.where(mark_pos, mark_fh * sev_fin, 0.0), 2)
        m_sum = _seq_sum(mark_fh, 2)
        tgt = soft.select(col(tau), (m_sev + 1e-6 * col(par.line_rate))
                          / (m_sum + 1e-6), tgt)
    mark_lvl = torch.clamp_max(torch.amax(mark_fh, dim=2), 1.0)

    # ---- 5. notification (cc.NOTIFICATION dispatch) -----------------------
    (emit, np_tmr, wslot), cc_notif = cc.dispatch(
        cc.NOTIFICATION, par.notif_code, par.notif,
        cc.NotifCtx(marked=mark_lvl, mark_fh=mark_fh, np_tmr_t=np_tmr_t,
                    hops=hops, rtt=sd.rtt, t=st.t, D=D, tau=tau),
        st.cc, only=only[1])
    rslot = (st.t % D).long()                          # [R]
    # one-hot ring ops: each (wslot[f], f) cell gets its single add/set,
    # every other cell an exact +0.0 / keep; the read row rslot is
    # disjoint from every write slot (0 < rtt < D).
    d_iota = torch.arange(D, device=dev)[None, :, None]          # [1, D, 1]
    w_hot = d_iota == wslot[:, None, :]                          # [R, D, F]
    trig_buf = st.trig_buf + torch.where(w_hot, emit[:, None, :], 0.0)
    tgt_buf = torch.where(w_hot & (emit[:, None, :] > 0), tgt[:, None, :],
                          st.tgt_buf)
    if tau is not None:
        e3 = emit[:, None, :]
        tgt_buf = soft.select(
            tau[:, None, None],
            torch.where(w_hot, e3 * tgt[:, None, :] + (1.0 - e3) * st.tgt_buf,
                        st.tgt_buf), tgt_buf)
    runs = torch.arange(R, device=dev)
    trig_rx = trig_buf[runs, rslot]
    cnp = (trig_rx > 0).to(f32)
    if tau is not None:
        cnp = soft.select(col(tau), torch.clamp_max(trig_rx, 1.0), cnp)
    tgt_rx = tgt_buf[runs, rslot]
    trig_buf = torch.where(d_iota == rslot[:, None, None], 0.0, trig_buf)

    # ---- 6. reaction (cc.REACTION dispatch) -------------------------------
    qdelay = _seq_sum(torch.where(holds_queue, qh, 0.0), 2) \
        / col(par.line_rate)
    react_out, cc_react = cc.dispatch(
        cc.REACTION, par.react_code, par.react,
        cc.ReactCtx(rate=st.rate, rp_target=st.rp_target, alpha=st.alpha,
                    byte_cnt=st.byte_cnt, tmr=st.tmr,
                    alpha_tmr=st.alpha_tmr, bc_stage=st.bc_stage,
                    t_stage=st.t_stage, hold=st.hold, cnp=cnp,
                    tgt_rx=tgt_rx, qdelay=qdelay, jitter=sd.jitter,
                    gen_rate=sd.gen_rate, line_rate=par.line_rate, dt=dt,
                    tau=tau),
        st.cc, packed=packed_react, only=only[2])

    new = FluidState(
        qh=qh, nicq=nicq, delivered=delivered, offered=offered,
        dropped=dropped, est=est, paused=paused, rate=react_out.rate,
        rp_target=react_out.rp_target, alpha=react_out.alpha,
        byte_cnt=react_out.byte_cnt, tmr=react_out.tmr,
        alpha_tmr=react_out.alpha_tmr, bc_stage=react_out.bc_stage,
        t_stage=react_out.t_stage, hold=react_out.hold, np_tmr=np_tmr,
        trig_buf=trig_buf, tgt_buf=tgt_buf, path_idx=path_idx,
        cc={**st.cc, **cc_mark, **cc_notif, **cc_react}, t=st.t + 1)
    trace = StepTrace(
        delivered=delivered, rate=react_out.rate, inst_thr=deliv_step / dt,
        max_q=torch.amax(B, dim=1),
        n_paused=(paused > 0.5).sum(dim=1).to(torch.int32),
        marked=marked, cnp=cnp > 0,
        n_nonmin=(path_idx > 0).sum(dim=1).to(torch.int32),
        ctrl=emit,
        pause_time=paused.sum(dim=1) * dt,
        vc_stall=paused.reshape(R, L, V).sum(dim=1) * dt)
    return new, trace


def make_step_fn(scn: Scenario, cfg: "CCConfig | CCSpec",
                 delay_slots: int | None = None, *,
                 reduce: str = "fused", dense_rows: int | None = None,
                 use_kernels: "bool | str" = False,
                 temperature: float = 0.0, device=None):
    """Returns ``step(state) -> (state, StepTrace)`` for one scenario
    run as a batch of R = 1 (``init_state(scn, cfg, device=...)``
    builds the matching state).  ``device=None`` is the card;
    ``use_kernels="mega"`` makes each step one ``megastep`` launch;
    ``temperature > 0`` runs the soft model (``use_kernels=False`` only).
    """
    if delay_slots is not None:
        _check_delay(scn, delay_slots)
    check_routing_paths(cfg, scn)
    refuse_unported(reduce=reduce, use_kernels=use_kernels,
                    temperature=temperature)
    dev = resolve_device(device)
    n_vcs = int(getattr(cfg.link, "n_vcs", 1))
    sd = scenario_device(scn, n_vcs=n_vcs, device=dev)
    par = step_params(cfg, temperature=temperature, device=dev)
    n_sw = int(scn.n_switches)
    dt = float(cfg.sim.dt)
    if dense_rows is None:
        dense_rows = dense_reduce_rows(scn, n_vcs) \
            if reduce == "fused" else 0
    plan = reduce_plan(sd, n_switches=n_sw, n_vcs=n_vcs,
                       dense_rows=dense_rows if reduce == "fused" else 0,
                       dt=dt)
    packed = cc.pack_react_rows(par.react, par.line_rate, plan.dt)
    tau = par.temperature if is_soft(temperature) else None

    def step(st: FluidState):
        return _step_body(st, sd, par, plan, n_switches=n_sw, reduce=reduce,
                          n_vcs=n_vcs, packed_react=packed, tau=tau)

    if kernel_tier(use_kernels) != "mega":
        return step
    mplan = mega.mega_plan(par, packed, plan.dt, sd=sd, plan=plan)

    def mega_step(st: FluidState):
        return mega.megastep(st, sd, par, plan, mplan, body=step,
                             n_switches=n_sw, n_vcs=n_vcs)

    return mega_step
