"""Declarative Experiment/Sweep API (port of ``repro.core.experiments``).

  * ``ScenarioSpec``   — a workload as plain data (fabric + traffic +
    timing); ``spec.build(cfg)`` compiles it to ``Scenario`` tensors.
    Host code, copied verbatim from the reference.
  * ``pad_scenario`` / ``stack_scenarios`` — N scenarios padded to one
    shape and stacked into one batched ``ScenarioDev`` on the device.
  * ``Sweep``          — N (config, scenario) points advanced together:
    every step of every run is one pass over the ``[R, ...]`` batch,
    and each per-flow CC kernel is one launch for all runs; with
    ``use_kernels="mega"`` each trace window of the whole batch is ONE
    ``megastep_block`` launch (the run axis is the kernel's grid, where
    the reference vmaps).
  * ``SWEEP_EXEC_CACHE`` — where ``Sweep.run`` finds its window runner,
    as the reference finds its compiled executable: one
    ``WindowExecutable`` per batch structure, on the card a CUDA graph
    of one trace window over tensors the entry owns, replayed once a
    window (``Sweep.prepare`` stays the eager API).
  * ``Sweep.run(mesh=...)`` — the run axis cut over the ranks of a
    ``torch.distributed.device_mesh.DeviceMesh`` (one process a rank,
    e.g. ``repro_torch.dist.sweep_mesh()``): each rank advances its slice
    of the padded batch on its own device and the traces are gathered,
    bitwise the one-launch result.

    from repro_torch.core import CCScheme, PAPER_CONFIG
    from repro_torch.core.experiments import ScenarioSpec, Sweep

    sweep = Sweep.grid(
        configs={s.name: PAPER_CONFIG.replace(scheme=s) for s in CCScheme},
        scenarios={"hol": ScenarioSpec.paper_incast(roll=0)})
    res = sweep.run()                       # on the card
    res = sweep.run(device="cpu")           # or on the CPU, by request
    res["DCQCN_REV/hol"].summary()
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
from typing import TYPE_CHECKING, NamedTuple, Sequence

import numpy as np
import torch

from ..kernels import fluid_step as mega
from ..kernels.capture import CapturedGraph, card_lock, warm_up
from . import cc
from .exec_cache import ExecutableCache, structural_signature
from .fluid import (FluidState, ReducePlan, Scenario, ScenarioDev,
                    _step_body, check_routing_paths, clamp_dense_rows,
                    delay_depth, dense_reduce_rows, init_state, is_soft,
                    kernel_tier, pool_counts, reduce_plan, refuse_unported,
                    resolve_device, scenario_arrays, step_params, _upload)
from .params import CCConfig, CCSpec
from .routing import PAD, route_hops
from .simulator import (SimResult, TraceSample, _resolve_steps,
                        block_fn_for, copy_leaves, decimating_scan,
                        flow_window)
from .topology import Topology

if TYPE_CHECKING:           # real import is lazy: repro_torch.net imports core
    from repro_torch.net import FabricSpec


# ---------------------------------------------------------------------------
# ScenarioSpec — declarative workload description
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """Fabric + traffic pattern + timing/volume, as plain data.

    ``kind`` selects the traffic pattern:
      * ``"incast"``      — ``n_senders``-to-1 into ``dst`` (+ optional
        victim flow), the paper's §II scene when n_senders=4 on arity 4.
      * ``"permutation"`` — seeded uniform random permutation traffic.
      * ``"pairs"``       — explicit (src, dst) pairs.
      * ``"flowspec"``    — fully explicit per-flow tuples (src, dst,
        timing, volume, rate, buffer) — what the collective-workload
        generators in ``repro.core.workloads`` emit.

    ``fabric`` names the network (any ``repro.net.FabricSpec``: CLOS,
    XGFT/tapered fat-tree, dragonfly); ``None`` keeps the legacy
    3-stage CLOS of ``arity``/``roll``.  Routing is table-driven for
    every fabric — the CLOS closed form is just one table builder.

    Timing: generators open at ``t_start`` and close at ``t_stop``
    (window mode) — or carry ``volume`` bytes each and stay open until
    done (equal-work mode, ``t_stop = inf``), the variant behind the
    paper's completion-time ordering.

    ``build(cfg)`` compiles the spec to ``Scenario`` tensors; rates and
    feedback delays derive from ``cfg.link`` / ``cfg.sim``.
    """

    kind: str = "incast"
    fabric: "FabricSpec | None" = None
    arity: int = 4
    roll: int = 0                 # D-mod-K digit roll (paper wirings)
    n_senders: int = 4
    dst: int = 16
    victim: tuple[int, int] | None = (3, 12)
    pairs: tuple[tuple[int, int], ...] = ()
    n_flows: int = 16             # permutation
    seed: int = 0
    t_start: float = 1e-3
    t_stop: float = 3e-3          # inf => volume (equal-work) mode
    volume: float = float("inf")  # bytes per flow; inf = window-limited
    nic_buffer: float = 4e6
    gen_rate: float | None = None  # B/s; None = line rate
    label: str = ""
    # adaptive routing: K candidate paths per flow (slot 0 minimal,
    # 1..K-1 Valiant detours from the fabric's RouteSet).  Which
    # candidate a flow actually uses is the *config's* choice
    # (``cfg.routing`` in {min, valiant, ugal}), so one multi-path
    # scenario serves a whole routing-mode sweep axis.
    n_paths: int = 1
    route_seed: int = 0           # VLB intermediate sampling seed
    # virtual channels: how flows map onto the config's
    # ``LinkParams.n_vcs`` queues ("slot" = detours on VC 1, "hop" =
    # dateline escalation — see ``repro.core.routing.assign_vc``).
    # Ignored (all VC 0) when the config runs a single VC.
    vc_mode: str = "slot"
    # per-flow tuples (kind == "flowspec"); empty = broadcast the scalar
    flow_src: tuple[int, ...] = ()
    flow_dst: tuple[int, ...] = ()
    flow_t_start: tuple[float, ...] = ()
    flow_t_stop: tuple[float, ...] = ()
    flow_volume: tuple[float, ...] = ()
    flow_rate: tuple[float, ...] = ()          # B/s; empty = gen_rate
    flow_nic_buffer: tuple[float, ...] = ()    # B; empty = nic_buffer
    # per-flow VC pin (overrides vc_mode on every hop; clipped to the
    # config's n_vcs) and victim-flow designation for the PFC-pathology
    # metrics (``SimResult.victim_slowdown``); empty = none
    flow_vc: tuple[int, ...] = ()
    flow_victim: tuple[bool, ...] = ()

    # -- canned specs -------------------------------------------------------

    @classmethod
    def paper_incast(cls, roll: int = 0, **kw) -> "ScenarioSpec":
        """The paper's §II.A scene: F0,F1,F4,F8 -> N16 plus the victim
        F3 -> N12.  roll=0 shares the victim's wire (Fig. 3 HoL); roll=1
        is wire-disjoint (Fig. 2's 25 GB/s aggregate)."""
        return cls(kind="pairs",
                   pairs=((0, 16), (1, 16), (4, 16), (8, 16), (3, 12)),
                   roll=roll, label=kw.pop("label", f"paper-roll{roll}"),
                   flow_victim=kw.pop("flow_victim",
                                      (False,) * 4 + (True,)),
                   **kw)

    @classmethod
    def paper_incast_volume(cls, roll: int = 0,
                            volume_bytes: float = 9.375e6,
                            **kw) -> "ScenarioSpec":
        """Equal-work variant for completion-time runs (each flow carries
        the 9.375 MB a fair-shared incast source admits in 1->3 ms)."""
        return cls(kind="pairs",
                   pairs=((0, 16), (1, 16), (4, 16), (8, 16), (3, 12)),
                   roll=roll, t_stop=float("inf"), volume=volume_bytes,
                   nic_buffer=kw.pop("nic_buffer", 2 * volume_bytes),
                   label=kw.pop("label", f"paper-vol-roll{roll}"),
                   flow_victim=kw.pop("flow_victim",
                                      (False,) * 4 + (True,)),
                   **kw)

    @classmethod
    def incast(cls, n_senders: int, dst: int = 16, *, victim: bool = True,
               **kw) -> "ScenarioSpec":
        return cls(kind="incast", n_senders=n_senders, dst=dst,
                   victim=(3, 12) if victim else None,
                   label=kw.pop("label", f"incast{n_senders}"), **kw)

    @classmethod
    def permutation(cls, n_flows: int, seed: int = 0, **kw) -> "ScenarioSpec":
        kw.setdefault("t_start", 0.1e-3)
        kw.setdefault("t_stop", 2e-3)
        return cls(kind="permutation", n_flows=n_flows, seed=seed,
                   label=kw.pop("label", f"perm{n_flows}"), **kw)

    @classmethod
    def flows(cls, pairs: Sequence[tuple[int, int]], **kw) -> "ScenarioSpec":
        return cls(kind="pairs", pairs=tuple(tuple(p) for p in pairs),
                   label=kw.pop("label", f"pairs{len(pairs)}"), **kw)

    @classmethod
    def from_workload(cls, wl, fabric: "FabricSpec | None" = None,
                      **kw) -> "ScenarioSpec":
        """Compile a ``repro.core.workloads.Workload`` onto a fabric.

        The workload's per-flow (src, dst, timing, volume, rate) tuples
        become a ``"flowspec"`` spec; NIC buffers default to twice each
        flow's volume (volume mode) or the scalar ``nic_buffer``.
        """
        nic = kw.pop("flow_nic_buffer", None)
        if nic is None and any(np.isfinite(v) for v in wl.volume):
            nic = tuple(2 * v if np.isfinite(v) else kw.get(
                "nic_buffer", 4e6) for v in wl.volume)
        return cls(kind="flowspec", fabric=fabric,
                   flow_src=wl.src, flow_dst=wl.dst,
                   flow_t_start=wl.t_start, flow_t_stop=wl.t_stop,
                   flow_volume=wl.volume,
                   flow_rate=wl.rate or (),
                   flow_nic_buffer=nic or (),
                   flow_victim=kw.pop(
                       "flow_victim", getattr(wl, "victim", ()) or ()),
                   flow_vc=kw.pop(
                       "flow_vc", getattr(wl, "vc", ()) or ()),
                   label=kw.pop("label", wl.label), **kw)

    # -- compilation to tensors --------------------------------------------

    @property
    def name(self) -> str:
        return self.label or self.kind

    def _fabric(self) -> "FabricSpec":
        if self.fabric is not None:
            return self.fabric
        from repro_torch.net import FabricSpec
        return FabricSpec.clos3(arity=self.arity, roll=self.roll)

    def _pairs(self, topo: Topology) -> list[tuple[int, int]]:
        if self.kind == "flowspec":
            if len(self.flow_src) != len(self.flow_dst):
                raise ValueError("flow_src / flow_dst length mismatch")
            return list(zip(self.flow_src, self.flow_dst))
        if self.kind == "pairs":
            return [tuple(p) for p in self.pairs]
        if self.kind == "incast":
            senders = [n for n in range(topo.n_nodes) if n != self.dst]
            out = [(s, self.dst) for s in senders[: self.n_senders]]
            if self.victim is not None:
                out.append(tuple(self.victim))
            return out
        if self.kind == "permutation":
            rng = np.random.RandomState(self.seed)
            n = topo.n_nodes
            perm = rng.permutation(n)
            srcs = rng.choice(n, size=self.n_flows,
                              replace=self.n_flows > n)
            out = []
            for s in srcs:
                d = int(perm[s % n])
                if d == s:
                    d = (d + 1) % n
                out.append((int(s), d))
            return out
        raise ValueError(f"unknown ScenarioSpec kind: {self.kind!r}")

    def _per_flow(self, field: tuple, scalar, F: int,
                  dtype=np.float32) -> np.ndarray:
        if field:
            if len(field) != F:
                raise ValueError(
                    f"per-flow tuple has {len(field)} entries for {F} flows")
            return np.asarray(field, dtype)
        return np.full((F,), scalar, dtype)

    def build(self, cfg: CCConfig) -> Scenario:
        fab = self._fabric()
        topo = fab.build(line_rate=cfg.link.line_rate)
        pairs = self._pairs(topo)
        # the general routing path: every fabric family precomputes a
        # validated per-(src,dst) table; scenarios route by lookup.
        # n_paths > 1 pulls the fabric's multi-path RouteSet instead:
        # slot 0 (minimal) fills the legacy single-path tensors, the
        # full candidate stack rides along for run-time selection.
        # flow_routes / flow_route_set are cached per (spec hash, pairs):
        # every grid point sharing a fabric reuses one extraction, and
        # the identical arrays downstream hit the device-upload and
        # incidence caches of ``scenario_device``.
        alt_routes = alt_hops = None
        if self.n_paths > 1:
            alt_routes, alt_hops = fab.flow_route_set(
                pairs, self.n_paths, seed=self.route_seed)
            routes = alt_routes[:, 0].copy()
        else:
            routes = fab.flow_routes(pairs)
        F = len(pairs)
        hops = route_hops(routes)
        # CNP feedback delay ~ 2 * hops * (prop + serialisation) + NIC
        # turnaround; quantised to dt steps, >= 2 so the loop is never
        # same-step.
        per_hop = cfg.link.propagation_delay + cfg.link.mtu / cfg.link.line_rate
        rtt = 2 * hops * per_hop + 1e-6
        rtt_steps = np.maximum(2, np.round(rtt / cfg.sim.dt)).astype(np.int32)
        rate = cfg.link.line_rate if self.gen_rate is None else self.gen_rate
        # per-flow rates: workloads are built before the config's line
        # rate is known, so inf means "line rate" and a negative entry
        # -f means "fraction f of line rate".
        rates = self._per_flow(self.flow_rate, rate, F).astype(np.float64)
        rates = np.where(np.isfinite(rates), rates, cfg.link.line_rate)
        rates = np.where(rates < 0, -rates * cfg.link.line_rate,
                         rates).astype(np.float32)
        # scalar stays scalar (host-side API compat); per-flow goes [F]
        nic = (self._per_flow(self.flow_nic_buffer, 0.0, F)
               if self.flow_nic_buffer else self.nic_buffer)
        # virtual channels: only materialised when the config runs more
        # than one, so single-VC scenarios stay byte-identical to the
        # pre-VC builds (vc=None, victim still carried for metrics)
        vc = None
        n_vcs = int(getattr(cfg.link, "n_vcs", 1))
        if n_vcs > 1:
            from .routing import assign_vc
            alt = alt_routes if alt_routes is not None \
                else routes[:, None, :]
            fv = np.asarray(self.flow_vc, np.int32) \
                if self.flow_vc else None
            vc = assign_vc(alt, n_vcs, mode=self.vc_mode, flow_vc=fv)
        victim = None
        if self.flow_victim:
            victim = self._per_flow(
                tuple(bool(v) for v in self.flow_victim), False, F,
                dtype=bool)
        elif self.kind == "incast" and self.victim is not None:
            victim = np.zeros((F,), bool)
            victim[-1] = True          # the appended victim pair
        return Scenario(
            routes=routes,
            hops=hops,
            gen_rate=rates,
            t_start=self._per_flow(self.flow_t_start, self.t_start, F),
            t_stop=self._per_flow(self.flow_t_stop, self.t_stop, F),
            volume=self._per_flow(self.flow_volume, self.volume, F),
            capacity=topo.link_capacity.astype(np.float32),
            sink_switch=topo.sink_switch(),
            n_switches=topo.n_switches,
            # feedback delay is pinned to the minimal path's RTT even for
            # multi-path scenarios: the delay line is per-flow static, and
            # a mode-dependent RTT would make routing="min" on a K-path
            # scenario diverge from the K=1 build of the same workload.
            rtt_steps=rtt_steps,
            nic_buffer=nic,
            alt_routes=alt_routes,
            alt_hops=alt_hops,
            vc=vc,
            victim=victim,
        )


# ---------------------------------------------------------------------------
# padding + stacking
# ---------------------------------------------------------------------------


def pad_scenario(scn: Scenario, n_flows: int, n_hops: int,
                 n_links: int, n_paths: int | None = None) -> Scenario:
    """Grow a scenario to [n_flows, n_hops] flows and n_links links.

    PAD flows never generate (t_start = inf, zero rate/volume) and cross
    no links; PAD links carry no flow and a nominal capacity — both are
    inert in every scatter/reduce of the step, so padding cannot change
    delivered bytes (property-tested in test_experiments).

    ``n_paths`` pads the candidate axis of multi-path scenarios; padded
    candidate slots are all-PAD with hop count 0, which the selection
    logic reads as "no such detour" (``n_alt`` counts real slots only).
    ``None`` keeps the scenario's own K (single-path stays single-path).
    """
    F, H = scn.routes.shape
    L = scn.capacity.shape[0]
    K = 1 if scn.alt_routes is None else scn.alt_routes.shape[1]
    n_paths = K if n_paths is None else n_paths
    if n_flows < F or n_hops < H or n_links < L or n_paths < K:
        raise ValueError(f"pad target ({n_flows},{n_hops},{n_links},"
                         f"{n_paths}) smaller than scenario "
                         f"({F},{H},{L},{K})")

    def pad_f(x, fill):
        return np.concatenate(
            [x, np.full((n_flows - F,) + x.shape[1:], fill, x.dtype)])

    routes = np.full((n_flows, n_hops), PAD, np.int32)
    routes[:F, :H] = scn.routes
    alt_routes = alt_hops = None
    if not (n_paths == 1 and scn.alt_routes is None):
        alt_routes = np.full((n_flows, n_paths, n_hops), PAD, np.int32)
        alt_hops = np.zeros((n_flows, n_paths), np.int32)
        if scn.alt_routes is None:
            alt_routes[:F, 0, :H] = scn.routes
            alt_hops[:F, 0] = scn.hops
        else:
            alt_routes[:F, :K, :H] = scn.alt_routes
            alt_hops[:F, :K] = scn.alt_hops
    # VC padding: PAD flows/slots ride VC 0 (forced, so the incidence
    # scratch mapping stays exact); victim padding is non-victim.
    vc = None
    if scn.vc is not None:
        Kv = scn.vc.shape[1]
        Kp = n_paths if alt_routes is not None else Kv
        vc = np.zeros((n_flows, Kp, n_hops), np.int32)
        vc[:F, :Kv, :H] = scn.vc
    victim = None if scn.victim is None \
        else pad_f(np.asarray(scn.victim, bool), False)
    return Scenario(
        routes=routes,
        hops=pad_f(scn.hops, 0),
        gen_rate=pad_f(scn.gen_rate, 0.0),
        t_start=pad_f(scn.t_start, np.inf),
        t_stop=pad_f(scn.t_stop, np.inf),
        volume=pad_f(scn.volume, 0.0),
        capacity=np.concatenate(
            [scn.capacity, np.full((n_links - L,), 1.0, np.float32)]),
        sink_switch=np.concatenate(
            [scn.sink_switch, np.full((n_links - L,), -1, np.int32)]),
        n_switches=scn.n_switches,
        rtt_steps=pad_f(scn.rtt_steps, 2),
        # per-flow buffers pad with inf (PAD flows never generate);
        # scalar buffers broadcast on device, so they pass through
        nic_buffer=pad_f(np.asarray(scn.nic_buffer, np.float32), np.inf)
        if np.ndim(scn.nic_buffer) else scn.nic_buffer,
        alt_routes=alt_routes,
        alt_hops=alt_hops,
        vc=vc,
        victim=victim,
    )


def stack_scenarios(scns: Sequence[Scenario], n_vcs: int = 1, *,
                    device=None):
    """Pad to a common shape and stack into one batched ScenarioDev.

    Returns (batched ScenarioDev on ``device`` (``None``: the card),
    padded host scenarios, n_switches_max).  ``n_vcs`` is the sweep's shared
    ``LinkParams.n_vcs``.
    """
    F = max(s.routes.shape[0] for s in scns)
    H = max(s.routes.shape[1] for s in scns)
    L = max(s.capacity.shape[0] for s in scns)
    K = max(1 if s.alt_routes is None else s.alt_routes.shape[1]
            for s in scns)
    n_sw = max(s.n_switches for s in scns)
    padded = [pad_scenario(s, F, H, L, n_paths=K) for s in scns]
    batched = _upload(ScenarioDev,
                      [scenario_arrays(s, n_vcs) for s in padded],
                      resolve_device(device))
    return batched, padded, n_sw


def batch_dense_rows(padded: Sequence[Scenario], n_vcs: int,
                     reduce: str = "fused",
                     dense_rows: int | None = None) -> int:
    """The dense-CSR row count one batch of padded scenarios runs with.

    The static row count must cover every run in the batch; any
    over-skew scenario disables the dense engine for the batch (0 = the
    segment-sum path, bit-identical), and the batch-wide max is
    re-clamped so one skewed run can't force the rest onto an oversized
    table.  An explicit ``dense_rows`` that cannot cover the batch also
    falls back to 0.  Shared by ``Sweep.run`` and the fleet planner so
    a shard pinned to the plan's value runs the exact program the full
    batch would.
    """
    if reduce != "fused":
        return 0
    if dense_rows is None:
        mls = [dense_reduce_rows(s, n_vcs) for s in padded]
        if 0 in mls:
            return 0
        s0 = padded[0]
        K = 1 if s0.alt_routes is None else s0.alt_routes.shape[1]
        return clamp_dense_rows(
            max(mls), s0.capacity.shape[0] * n_vcs,
            s0.routes.shape[0] * K * s0.routes.shape[1])
    if dense_rows > 0 and any(
            not 0 < dense_reduce_rows(s, n_vcs) <= dense_rows
            for s in padded):
        return 0                     # can't cover the batch: safe path
    return int(dense_rows)


# ---------------------------------------------------------------------------
# Sweep — N points advanced together on one device
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    name: str
    cfg: CCConfig
    scenario: Scenario            # built tensors (specs compile on add)


def _replace_path(cfg: CCConfig, path: str, value) -> CCConfig:
    """dataclasses.replace through dotted paths, e.g. "dcqcn.kmin"."""
    head, _, rest = path.partition(".")
    if not rest:
        return dataclasses.replace(cfg, **{head: value})
    sub = getattr(cfg, head)
    return dataclasses.replace(
        cfg, **{head: _replace_path(sub, rest, value)})


def config_grid(cfg: CCConfig, **axes) -> dict[str, CCConfig]:
    """{"kmin=8192": cfg', ...} over the product of dotted-path axes.

    ``config_grid(cfg, **{"dcqcn.kmin": [8e3, 15e3], "rev.erp_rai": [...]})``
    """
    out = {"": cfg}
    for path, values in axes.items():
        leaf = path.rsplit(".", 1)[-1]
        nxt = {}
        for name, c in out.items():
            for v in values:
                key = f"{leaf}={v:g}" if isinstance(v, (int, float)) else \
                    f"{leaf}={v}"
                nxt[f"{name}/{key}" if name else key] = \
                    _replace_path(c, path, v)
        out = nxt
    return out


class Staged(NamedTuple):
    """One batch staged on the device by ``Sweep.prepare``."""

    step: object              # (FluidState) -> (FluidState, StepTrace)
    state: FluidState         # batched initial state
    sd: ScenarioDev
    par: object               # StepParams
    plan: ReducePlan
    n_switches: int
    dense_rows: int
    n_samples: int
    trace_every: int
    block: object = None      # mega tier: (FluidState) -> (FluidState,
    #                           TraceSample), one launch per trace window


class WindowStatic(NamedTuple):
    """The static configuration of one trace window: the reference's
    static scan tuple without the scan depth (a window runner is replayed
    ``n_samples`` times, so the depth does not change the program) and
    without the megakernel's substep block (``trace_every`` on the mega
    tier).  ``soft`` says whether the window runs the soft model (any
    run's temperature > 0): the step's ops differ, so it is part of the
    cache key, and a hard batch's window never reads the temperature."""

    trace_every: int
    dt: float
    n_switches: int
    reduce: str
    dense_rows: int
    tier: str                 # kernel_tier(use_kernels)
    n_vcs: int
    soft: bool = False


class WindowInputs(NamedTuple):
    """Every tensor one trace window of a staged batch reads: the state
    it advances and the batch's constants."""

    state: FluidState
    sd: ScenarioDev
    par: object               # StepParams
    plan: ReducePlan
    packed: dict              # cc.pack_react_rows of ``par``
    mplan: object = None      # mega tier: the block's MegaPlan


def window_fn(inp: WindowInputs, static: WindowStatic):
    """``window(state) -> (state, TraceSample)``: one trace window over
    ``inp``'s constants — ``trace_every`` steps folded on the device
    (flow tiers), or one ``megastep_block`` launch (mega tier)."""
    s = static
    if s.tier == "mega":
        return block_fn_for(inp.sd, inp.par, inp.plan, inp.packed,
                            inp.mplan, n_switches=s.n_switches,
                            n_vcs=s.n_vcs, trace_every=s.trace_every,
                            dt=s.dt, reduce=s.reduce)

    tau = inp.par.temperature if s.soft else None

    def step(st):
        return _step_body(st, inp.sd, inp.par, inp.plan,
                          n_switches=s.n_switches, reduce=s.reduce,
                          n_vcs=s.n_vcs, packed_react=inp.packed, tau=tau)

    return flow_window(step, s.trace_every, s.dt, s.n_vcs,
                       inp.state.nicq.device)


def _tree_map(fn, x):
    """``fn`` over every tensor leaf of a NamedTuple / dict tree; other
    leaves (None, the plans' Python ints) pass through."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    if hasattr(x, "_fields"):
        return type(x)(*[_tree_map(fn, v) for v in x])
    return x


def _tensor_leaves(x, out: list) -> list:
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, dict):
        for k in sorted(x):
            _tensor_leaves(x[k], out)
    elif hasattr(x, "_fields"):
        for v in x:
            _tensor_leaves(v, out)
    return out


def _copy_into(dst, src) -> None:
    """``dst.copy_(src)`` leaf by leaf over two trees of one structure
    (one launch a dtype, not one a leaf)."""
    copy_leaves(_tensor_leaves(dst, []), _tensor_leaves(src, []))


class WindowExecutable:
    """One entry of ``SWEEP_EXEC_CACHE``: the trace window of one batch
    structure, over static tensors the entry owns.

    ``inputs`` is the entry's own copy of a batch's ``WindowInputs`` (never
    a tensor of the caller's ``Staged`` or of the upload cache, which it
    overwrites); ``bind`` copies another batch of the same structure into
    it.  ``start(state)`` loads a run's initial state; each ``advance()``
    runs one window, leaves the new state in ``state`` and returns the
    window's ``TraceSample`` (rewritten by the next call).

    On the card the entry is built from a run's inputs: that run's first
    window runs eagerly on a side stream (the warm-up the capture needs,
    real work: its sample is the first ``advance()``'s), then the second
    is captured as a CUDA graph whose last ops copy the new state into
    ``state``, and every later window is one replay.  A failed capture
    raises.  On the CPU the same window runs eagerly over the same
    tensors.

    One run at a time: the entry's tensors hold one batch, so a run takes
    the entry for itself from ``bind`` through its last ``advance`` and
    the copy of its final state (``_sweep_executable``, a context
    manager).  The cache's ``release()`` of an entry that a run holds
    waits for that run to let go."""

    def __init__(self, inputs: WindowInputs, static: WindowStatic,
                 token: int = 0):
        self.inputs = _tree_map(torch.clone, inputs)
        self.device = self.state.nicq.device
        self.window = window_fn(self.inputs, static)
        self.graph = None
        self._first = None
        self._bound = token        # the lease whose batch the tensors hold
        self._lock = threading.Lock()     # held by the run using the entry
        self._guard = threading.Lock()    # _owner / _retired
        self._owner = None
        self._retired = False
        if self.device.type == "cuda":
            with card_lock(self.device):
                self._first = warm_up(self._run_window)
                self.graph = CapturedGraph(self._run_window)

    @property
    def state(self) -> FluidState:
        return self.inputs.state

    @property
    def capture_s(self) -> float:
        return 0.0 if self.graph is None else self.graph.capture_s

    def nbytes(self) -> int:
        """Bytes of the static tensors the entry owns (its graph's pool
        not counted)."""
        return sum(t.numel() * t.element_size()
                   for t in _tensor_leaves(self.inputs, []))

    def _run_window(self):
        st, sample = self.window(self.state)
        _copy_into(self.state, st)
        return sample

    def bind(self, inputs: WindowInputs, token: int = 0) -> None:
        """Copy a batch of this entry's structure into its tensors (its
        initial state comes with ``start``)."""
        for f in WindowInputs._fields:
            if f != "state":
                _copy_into(getattr(self.inputs, f), getattr(inputs, f))
        self._first = None
        self._bound = token

    def start(self, st: FluidState) -> None:
        """Load a run's initial state — unless the entry was just built
        from that run, whose first window it has already advanced."""
        if self._first is None:
            _copy_into(self.state, st)

    def advance(self):
        if self._first is not None:
            sample, self._first = self._first, None
            return sample
        if self.graph is None:
            return self._run_window()
        self.graph.replay()
        return self.graph.out

    def acquire(self) -> bool:
        """Take the entry for the calling thread's run (blocking while
        another run holds it); False if it was released meanwhile, and
        then the caller looks it up again.  A thread that already holds
        the entry may not take it twice: a nested run of one batch
        structure would overwrite the outer run's batch."""
        me = threading.get_ident()
        if self._owner == me:
            raise RuntimeError(
                "this thread already runs this sweep entry: nested runs "
                "of one batch structure in one thread would overwrite "
                "each other's batch")
        self._lock.acquire()
        with self._guard:
            if self._retired:
                self._lock.release()
                return False
            self._owner = me
        return True

    def unlock(self) -> None:
        """Let the entry go (and free it if the cache released it while
        the run held it)."""
        with self._guard:
            self._owner = None
            free = self._retired
        self._lock.release()
        if free:
            self._free()

    def release(self) -> None:
        """Free the graph, its memory pool and the owned tensors — once
        the run holding the entry, if any, lets it go."""
        with self._guard:
            self._retired = True
            if self._owner is not None:
                return
        self._free()

    def _free(self) -> None:
        with card_lock(self.device):
            if self.graph is not None:
                self.graph.release()
            self.graph = self._first = self.inputs = self.window = None


#: The sweep-executable cache: every ``Sweep.run`` resolves its trace
#: window runner here (a ``WindowExecutable``), keyed by the structural
#: signature of its ``WindowStatic`` and ``WindowInputs``: the static
#: configuration, every leaf's path, shape, dtype and device, and the
#: plans' Python ints (the segment schedule's long items, the
#: megakernel's launch geometry).  A module-level singleton, as in the
#: reference, so its ``CacheStats`` can be read by whoever drives it.
SWEEP_EXEC_CACHE = ExecutableCache(capacity=32, name="sweep")


_LEASES = itertools.count(1)


@contextlib.contextmanager
def _sweep_executable(static: WindowStatic, inputs: WindowInputs):
    """``with _sweep_executable(static, inputs) as runner:`` — one sweep
    launch's cached window runner, held by the calling thread for the
    block: a miss builds (and, on the card, captures) an entry from
    ``inputs``; otherwise ``inputs`` are bound into the entry's own
    tensors once the run has it to itself.  Other threads' runs of the
    same structure wait; on the card every run's device work waits for
    the card's lock (``kernels.capture.card_lock``), held here for the
    block."""
    token = next(_LEASES)
    key = structural_signature(static, inputs)
    with card_lock(inputs.state.nicq.device):
        while True:
            entry = SWEEP_EXEC_CACHE.get_or_build(
                key, lambda: WindowExecutable(inputs, static, token))
            if entry.acquire():
                break
        try:
            if entry._bound != token:
                entry.bind(inputs, token)
            yield entry
        finally:
            entry.unlock()


def _mesh_shard(mesh) -> tuple[int, int]:
    """(this rank's shard of the run axis, the shard count): the run axis
    is cut over every dim of ``mesh``, row-major, as the reference's
    ``shard_map`` over ``P(mesh.axis_names)`` cuts it."""
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            f"mesh must be a torch.distributed.device_mesh.DeviceMesh "
            f"(e.g. repro_torch.dist.sweep_mesh()), not "
            f"{type(mesh).__name__}")
    coord = mesh.get_coordinate()
    if coord is None:
        import torch.distributed as dist
        raise ValueError(f"rank {dist.get_rank()} is outside the mesh "
                         f"{mesh}: run a sharded sweep on its ranks only")
    return (int(np.ravel_multi_index(coord, tuple(mesh.shape))),
            int(mesh.size()))


def _sweep_device(mesh, device) -> torch.device:
    """The device a run advances on: ``device`` as ``resolve_device``
    reads it, or with a mesh and no ``device`` this rank's device of the
    mesh's type (its current card, or the CPU)."""
    if mesh is None:
        return resolve_device(device)
    _mesh_shard(mesh)                         # a DeviceMesh holding us
    dev = resolve_device(mesh.device_type if device is None else device)
    if dev.type != mesh.device_type:
        raise ValueError(f"device {dev} is not of the mesh's device type "
                         f"{mesh.device_type!r}")
    return dev


def _gather_runs(mesh, final: FluidState, traces: TraceSample):
    """Every rank's run slice of ``final`` ([n, ...]) and ``traces`` ([T,
    n, ...]) concatenated in mesh order: one all-gather a mesh dim, last
    dim first (row-major), of one byte buffer holding every leaf, runs
    leading, one leaf after another.  Over NCCL the buffer is on the
    card; otherwise (gloo) each leaf is copied straight into a host
    buffer, so the card holds no second copy of the result.  Returns
    the whole batch's (final, traces) as tensors."""
    import torch.distributed as dist
    runs = []
    _tree_map(runs.append, final)
    for x in traces:
        runs.append(x.movedim(1, 0))          # runs lead: [n, T, ...]
    groups = [mesh.get_group(dim) for dim in range(mesh.ndim)]
    on_card = all(dist.get_backend(g) == "nccl" for g in groups)
    sizes = [x.numel() * x.element_size() for x in runs]
    buf = torch.empty(sum(sizes), dtype=torch.uint8,
                      device=runs[0].device if on_card else "cpu")
    at = 0
    for x, size in zip(runs, sizes):
        buf[at:at + size].copy_(x.contiguous().reshape(-1).view(torch.uint8))
        at += size
    for dim in reversed(range(mesh.ndim)):
        parts = [torch.empty_like(buf) for _ in range(mesh.size(dim))]
        dist.all_gather(parts, buf, group=groups[dim])
        buf = torch.cat(parts)
    ranks = buf.view(-1, at)                  # [mesh size, one rank's bytes]
    out, at = [], 0
    for x, size in zip(runs, sizes):
        block = ranks[:, at:at + size].contiguous().view(x.dtype)
        out.append(block.reshape((-1,) + x.shape[1:]))
        at += size
    it = iter(out)
    final = _tree_map(lambda _: next(it), final)
    return final, TraceSample(*[x.movedim(0, 1) for x in it])


class Sweep:
    """A batch of (config, scenario) points advanced together.

    Points come in as ``(name, cfg, scenario-or-spec)`` triples; specs
    are compiled against their point's config.  All points must agree on
    ``sim.dt``, ``sim.trace_every`` and ``link.n_vcs`` (they share the
    loop and the queue layout); shapes are padded to the batch maximum.
    """

    def __init__(self, points: Sequence[tuple[str, "CCConfig | CCSpec",
                                              "ScenarioSpec | Scenario"]]):
        if not points:
            raise ValueError("empty sweep")
        self.points: list[SweepPoint] = []
        names = set()
        for name, cfg, scn in points:
            if name in names:
                raise ValueError(f"duplicate sweep point name: {name!r}")
            names.add(name)
            if isinstance(scn, ScenarioSpec):
                scn = scn.build(cfg)
            check_routing_paths(cfg, scn)
            self.points.append(SweepPoint(name, cfg, scn))
        dts = {p.cfg.sim.dt for p in self.points}
        kps = {p.cfg.sim.trace_every for p in self.points}
        if len(dts) > 1 or len(kps) > 1:
            raise ValueError(
                f"sweep points disagree on sim.dt ({dts}) or "
                f"trace_every ({kps}); they share one scan")
        vcs = {int(getattr(p.cfg.link, "n_vcs", 1)) for p in self.points}
        if len(vcs) > 1:
            raise ValueError(
                f"sweep points disagree on link.n_vcs ({sorted(vcs)}); "
                f"the VC count is a static shape parameter shared by "
                f"the whole batch — run them as separate sweeps")
        self.n_vcs = vcs.pop()

    @classmethod
    def grid(cls, configs, scenarios) -> "Sweep":
        """Cross named configs with named scenarios/specs.

        ``configs``: dict[str, CCConfig | CCSpec] (or one config);
        ``scenarios``: dict[str, ScenarioSpec | Scenario] (or one).
        Point names are "cfg/scenario" (or the sole non-dict's name).
        """
        if isinstance(configs, (CCConfig, CCSpec)):
            configs = {"": configs}
        if isinstance(scenarios, (ScenarioSpec, Scenario)):
            scenarios = {getattr(scenarios, "name", "scenario"): scenarios}
        points = []
        for cn, cfg in configs.items():
            for sn, scn in scenarios.items():
                name = f"{cn}/{sn}" if cn and sn else (cn or sn)
                points.append((name, cfg, scn))
        return cls(points)

    @property
    def names(self) -> list[str]:
        return [p.name for p in self.points]

    def subset(self, keys: Sequence["str | int"]) -> "Sweep":
        """A new Sweep over the named (or indexed) points."""
        names = self.names
        pts = []
        for key in keys:
            r = key if isinstance(key, int) else names.index(key)
            p = self.points[r]
            pts.append((p.name, p.cfg, p.scenario))
        return Sweep(pts)

    def _prepare(self, n_steps, trace_every, *, mesh, reduce, use_kernels,
                 pad_runs_to, min_delay_slots, dense_rows, temperature,
                 min_switches, device):
        """Stack, pad and stage the batch; returns ``(WindowStatic,
        WindowInputs, n_samples)`` — everything a launch needs short of
        the window runner.  Shared by ``prepare`` and ``run``.

        With a ``mesh`` the batch is padded to a multiple of its size,
        staged whole as one launch stages it (delay slots, switch count,
        dense rows and pool depth from the whole batch), and cut to this
        rank's contiguous slice before its plans are built."""
        refuse_unported(reduce=reduce, use_kernels=use_kernels,
                        temperature=temperature)
        part = None if mesh is None else _mesh_shard(mesh)
        dev = _sweep_device(mesh, device)
        cfg0 = self.points[0].cfg
        n_samples, k = _resolve_steps(cfg0, n_steps, trace_every)
        scns = [p.scenario for p in self.points]
        cfgs = [p.cfg for p in self.points]
        R = len(self.points)
        R_target = R if pad_runs_to is None else max(R, int(pad_runs_to))
        if part is not None and R_target % part[1]:
            R_target += part[1] - R_target % part[1]
        if R_target > R:                      # replicate the last run
            scns = scns + [scns[-1]] * (R_target - R)
            cfgs = cfgs + [cfgs[-1]] * (R_target - R)
        sd_b, padded, n_sw = stack_scenarios(scns, n_vcs=self.n_vcs,
                                             device=dev)
        if min_switches is not None:
            n_sw = max(n_sw, int(min_switches))
        D = max(delay_depth(s) for s in padded)
        if min_delay_slots is not None:
            D = max(D, int(min_delay_slots))
        st_b = init_state(padded, cfgs, delay_slots=D, device=dev)
        par_b = step_params(cfgs, temperature=temperature, device=dev)
        dense_rows = batch_dense_rows(padded, self.n_vcs, reduce,
                                      dense_rows)
        pool_rows = None
        if part is not None:                  # this rank's slice
            pool_rows = int(pool_counts(sd_b, n_sw).max(initial=0))
            per = R_target // part[1]
            lo = part[0] * per
            cut = lambda x: x[lo:lo + per]                 # noqa: E731
            st_b, sd_b, par_b = (_tree_map(cut, t)
                                 for t in (st_b, sd_b, par_b))
        dt = float(cfg0.sim.dt)
        plan = reduce_plan(sd_b, n_switches=n_sw, n_vcs=self.n_vcs,
                           dense_rows=dense_rows, dt=dt, pool_rows=pool_rows)
        packed = cc.pack_react_rows(par_b.react, par_b.line_rate, plan.dt)
        tier = kernel_tier(use_kernels)
        mplan = None
        if tier == "mega":
            mplan = mega.mega_plan(par_b, packed, plan.dt, sd=sd_b,
                                   plan=plan, window=float(k * dt))
        static = WindowStatic(
            trace_every=k, dt=dt, n_switches=n_sw, reduce=reduce,
            dense_rows=int(dense_rows), tier=tier, n_vcs=self.n_vcs,
            soft=is_soft(temperature))
        return static, WindowInputs(state=st_b, sd=sd_b, par=par_b,
                                    plan=plan, packed=packed,
                                    mplan=mplan), n_samples

    def prepare(self, n_steps: int | None = None,
                trace_every: int | None = None, *, mesh=None,
                reduce: str = "fused", use_kernels: "bool | str" = False,
                pad_runs_to: int | None = None,
                min_delay_slots: int | None = None,
                dense_rows: int | None = None, temperature: float = 0.0,
                min_switches: int | None = None, device=None):
        """Stack, pad and stage the batch on the device; returns a
        ``Staged`` whose ``step(state) -> (state, StepTrace)`` advances
        every run one ``dt`` from the batched initial ``state`` (one
        ``megastep`` launch with ``use_kernels="mega"``, which also
        stages ``block``: one ``megastep_block`` launch per window).
        This is the eager API: each call issues its launches from Python
        (``decimating_scan`` over it is ``run``'s result, uncaptured).
        With a ``mesh`` (see ``run``) it stages this rank's slice of the
        padded batch on this rank's device.
        """
        static, inp, n_samples = self._prepare(
            n_steps, trace_every, mesh=mesh, reduce=reduce,
            use_kernels=use_kernels, pad_runs_to=pad_runs_to,
            min_delay_slots=min_delay_slots, dense_rows=dense_rows,
            temperature=temperature, min_switches=min_switches,
            device=device)
        sd_b, par_b, plan = inp.sd, inp.par, inp.plan
        n_sw, n_vcs = static.n_switches, static.n_vcs
        tau = par_b.temperature if static.soft else None

        def step(st):
            return _step_body(st, sd_b, par_b, plan, n_switches=n_sw,
                              reduce=static.reduce, n_vcs=n_vcs,
                              packed_react=inp.packed, tau=tau)

        block = None
        if static.tier == "mega":
            body, mplan = step, mega.mega_plan(
                par_b, inp.packed, plan.dt, sd=sd_b, plan=plan)

            def step(st):
                return mega.megastep(st, sd_b, par_b, plan, mplan,
                                     body=body, n_switches=n_sw,
                                     n_vcs=n_vcs)

            block = window_fn(inp, static)
        return Staged(step=step, state=inp.state, sd=sd_b, par=par_b,
                      plan=plan, n_switches=n_sw,
                      dense_rows=static.dense_rows, n_samples=n_samples,
                      trace_every=static.trace_every, block=block)

    def run(self, n_steps: int | None = None,
            trace_every: int | None = None, *, mesh=None,
            reduce: str = "fused", use_kernels: "bool | str" = False,
            pad_runs_to: int | None = None,
            min_delay_slots: int | None = None,
            dense_rows: int | None = None, temperature: float = 0.0,
            min_switches: int | None = None, device=None) -> "SweepResult":
        """Advance all points together and pull the decimated traces.

        ``device=None`` runs on the card and raises when there is none;
        pass ``device="cpu"`` to run on the CPU.

        Each trace window runs through the batch structure's entry in
        ``SWEEP_EXEC_CACHE``: on the card a CUDA graph captured on the
        structure's first run and replayed once a window afterwards (the
        same kernels in the same order as ``prepare``'s eager calls, so
        the same bits); on the CPU the same window run eagerly.

        ``reduce``: ``"fused"`` (default: the dense-CSR walk, or the
        ``segment_reduce`` kernel on the card where a queue is too
        skewed for it), ``"pallas"`` (always ``segment_reduce``) or
        ``"scat"`` (CPU only).  ``use_kernels`` False and True run the
        same path: the per-flow CC stages launch their CUDA kernels on
        the card and their plain versions on the CPU.
        ``use_kernels="mega"`` makes each trace window of the whole
        batch one ``megastep_block`` launch (not with ``"pallas"``).

        ``mesh``: a ``torch.distributed.device_mesh.DeviceMesh`` (e.g.
        ``repro_torch.dist.sweep_mesh()``) cuts the run axis over its
        ranks, one process a rank, every rank calling ``run``: the batch
        is padded to a multiple of ``mesh.size()`` by replicating the last
        point, staged whole as one launch stages it, and each rank
        advances its contiguous slice on its device (``device=None``:
        its current card for a cuda mesh, the CPU for a cpu mesh) on
        any tier and engine; the finals and traces are gathered over the
        mesh (NCCL on the card, host copies over gloo) and every rank
        returns the whole result, padding dropped.  Results are bitwise
        identical to the single-launch run, run for run.  A rank outside
        the mesh raises ValueError; a ``mesh`` that is no ``DeviceMesh``
        TypeError.

        ``temperature`` > 0 runs the soft-relaxed dynamics of
        ``repro_torch.tune`` (every run of the batch at that temperature,
        held per run in ``StepParams.temperature``; only with
        ``use_kernels=False``, since the kernel tiers compute the hard
        step alone and raise ValueError).  ``temperature=0.0`` is the
        hard model and builds the very window of the default run (the
        same cache entry, the same bits).

        ``pad_runs_to`` / ``min_delay_slots`` / ``dense_rows`` /
        ``min_switches`` pin the batch geometry as in the reference;
        results are unaffected (padding runs are dropped on return).
        """
        dev = _sweep_device(mesh, device)
        with card_lock(dev):
            static, inp, n_samples = self._prepare(
                n_steps, trace_every, mesh=mesh, reduce=reduce,
                use_kernels=use_kernels, pad_runs_to=pad_runs_to,
                min_delay_slots=min_delay_slots, dense_rows=dense_rows,
                temperature=temperature, min_switches=min_switches,
                device=dev)
            with _sweep_executable(static, inp) as runner:
                final, tr = decimating_scan(None, inp.state, n_samples,
                                            static.trace_every, static.dt,
                                            self.n_vcs, runner=runner)
            if mesh is not None:
                final, tr = _gather_runs(mesh, final, tr)
            return self.collect(final, tr, static.trace_every)

    def collect(self, final: FluidState, traces: TraceSample,
                trace_every: int) -> "SweepResult":
        """A scan of this sweep's batch (``decimating_scan``'s final
        state and ``[T, R, ...]`` traces) pulled to the host as a
        ``SweepResult``; padding runs are dropped."""
        from ..convert import state_to_numpy
        R = len(self.points)
        n_samples = traces.delivered.shape[0]
        times = (np.arange(n_samples) + 1) * trace_every \
            * self.points[0].cfg.sim.dt
        # samples stack on axis 0 -> [T, R, ...]; runs lead on host
        host = TraceSample(*[np.moveaxis(x.cpu().numpy(), 0, 1)[:R]
                             for x in traces])
        fin = state_to_numpy(final)
        fin = FluidState(*[x[:R] for x in fin[:-2]],
                         cc={kk: v[:R] for kk, v in fin.cc.items()},
                         t=fin.t[:R])
        return SweepResult(points=self.points, times=times, traces=host,
                           final=fin, trace_every=trace_every)


def trim_final(fin: FluidState, F: int) -> FluidState:
    """An (unbatched) final state trimmed back to its true flow count —
    the inverse of ``pad_scenario`` for result views (PAD flows are
    inert, so trimming loses nothing).  Used by the sweep's per-point
    views and by the what-if engine's bucket-padded query slicing."""
    flow = lambda x: x[:F]
    return FluidState(
        qh=flow(fin.qh), nicq=flow(fin.nicq), delivered=flow(fin.delivered),
        offered=flow(fin.offered), dropped=flow(fin.dropped),
        est=flow(fin.est), paused=fin.paused, rate=flow(fin.rate),
        rp_target=flow(fin.rp_target), alpha=flow(fin.alpha),
        byte_cnt=flow(fin.byte_cnt), tmr=flow(fin.tmr),
        alpha_tmr=flow(fin.alpha_tmr), bc_stage=flow(fin.bc_stage),
        t_stage=flow(fin.t_stage), hold=flow(fin.hold),
        np_tmr=flow(fin.np_tmr), trig_buf=fin.trig_buf[:, :F],
        tgt_buf=fin.tgt_buf[:, :F], path_idx=flow(fin.path_idx),
        cc={k: flow(v) for k, v in fin.cc.items()},
        t=fin.t)


def _slice_final(fin: FluidState, r: int, F: int) -> FluidState:
    """Run r's final state, trimmed back to its true flow count."""
    return trim_final(FluidState(*[x[r] for x in fin[:-2]],
                                 cc={k: v[r] for k, v in fin.cc.items()},
                                 t=fin.t[r]), F)


@dataclasses.dataclass
class SweepResult:
    """All runs' decimated traces, indexable by point name (or index)
    into per-point ``SimResult`` views trimmed to their true flows."""

    points: list[SweepPoint]
    times: np.ndarray              # [T] window-end seconds
    traces: object                 # TraceSample of [R, T, ...] numpy
    final: object                  # FluidState with leading [R]
    trace_every: int

    @property
    def names(self) -> list[str]:
        return [p.name for p in self.points]

    def __len__(self) -> int:
        return len(self.points)

    def __contains__(self, name: str) -> bool:
        return name in self.names

    def __getitem__(self, key: "str | int") -> SimResult:
        if isinstance(key, int):
            r = key
        elif key in self.names:
            r = self.names.index(key)
        else:
            raise KeyError(f"{key!r} not in sweep; points: {self.names}")
        p = self.points[r]
        F = p.scenario.routes.shape[0]
        tr = self.traces
        return SimResult(
            cfg=p.cfg, scn=p.scenario, times=self.times,
            delivered=tr.delivered[r][:, :F],
            rate=tr.rate[r][:, :F],
            inst_thr=tr.inst_thr[r][:, :F],
            max_q=tr.max_q[r], n_paused=tr.n_paused[r],
            marked=tr.marked[r][:, :F], cnp=tr.cnp[r][:, :F],
            n_nonmin=tr.n_nonmin[r],
            final=_slice_final(self.final, r, F),
            ctrl=tr.ctrl[r][:, :F],
            trace_every=self.trace_every,
            pause_time=None if tr.pause_time is None
            else tr.pause_time[r],
            vc_stall=None if tr.vc_stall is None else tr.vc_stall[r])

    def items(self):
        for i, p in enumerate(self.points):
            yield p.name, self[i]

    def to_dict(self, *, traces: bool = True) -> dict:
        """JSON-ready dict in the reference's wire format; the full form
        round-trips bit-exactly via :meth:`from_dict` (see
        ``core.serialize``)."""
        from .serialize import sweepresult_to_dict
        return sweepresult_to_dict(self, traces=traces)

    @classmethod
    def from_dict(cls, d: dict) -> "SweepResult":
        from .serialize import sweepresult_from_dict
        return sweepresult_from_dict(d)

    def summary(self) -> dict[str, dict]:
        """Headline numbers per point (the Fig. 2/3 table in one dict)."""
        return {name: res.summary() for name, res in self.items()}
