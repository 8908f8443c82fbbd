"""Deterministic decomposition of a Sweep grid into content-addressed
shards (port of ``repro.fleet.plan``).

The same shard split and the same point, shard and plan digests as the
reference for the same sweep: they hash host config and scenario content
(numpy), which is the same in both packages.  The port's plan carries a
``device`` (None = the card) instead of the reference's ``interpret``;
the digests hash ``interpret: False`` where the reference hashes its
flag, so a port plan and a reference plan of one sweep agree.

A :class:`FleetPlan` cuts an N-point :class:`~repro_torch.core.experiments.
Sweep` into :class:`ShardSpec`\\ s a scheduler can execute in any order,
on any worker, any number of times, and still reassemble the exact
one-launch result:

  * **content-addressed** — every shard carries a sha256 digest over
    its points' configs + scenario tensors + the plan's static launch
    parameters, so a resume journal can recognise "this exact work is
    already done" across processes and restarts (python's randomised
    ``hash()`` never enters the digest);
  * **grouped by executable signature** — shards are bucketed by the
    structural key of ``core.exec_cache.structural_signature``: the
    plan pins the padded shape envelope (flows/hops/links/paths), the
    static switch count, delay-line depth, dense-CSR rows and the run-
    axis width per bucket, so every shard in a bucket resolves to ONE
    cached window (on the card one CUDA-graph capture per bucket);
  * **cost-balanced** — ragged grids (mixed flow counts / fabrics) are
    rebalanced by the analytic HBM roofline of the fluid step (the
    reference's bytes-per-step model, :func:`fluid_step_bytes`), via
    greedy longest-processing-time assignment; residual raggedness is
    the scheduler's work-stealing problem.

Bitwise discipline: a shard pinned to the plan's envelope runs the
exact program the full batch would — PAD flows/links, extra delay
slots, extra switch rows and replicated pad runs are all inert by
construction — so the merged fleet result is bitwise the uninterrupted
``Sweep.run()`` (asserted in ``tests/test_torch_fleet.py``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Sequence

import numpy as np

from ..core.experiments import (Sweep, SweepPoint, batch_dense_rows,
                                pad_scenario)
from ..core.fluid import delay_depth
from ..core.serialize import config_to_dict
from ..core.simulator import _resolve_steps

#: HBM bandwidth the cost model normalises against: the NVIDIA H100 SXM
#: 80GB (HBM3), 3.35 TB/s.  The planner only uses ratios of it, but
#: ``serve.whatif.EngineConfig.fleet_threshold`` is in seconds, so this
#: figure decides when the what-if engine delegates a batch to the fleet.
HBM_BW = 3.35e12


def fluid_step_bytes(n_flows: int, n_paths: int, n_hops: int,
                     n_links: int, n_vcs: int = 1) -> float:
    """Analytic HBM bytes one fluid substep moves (f32 vectors).

    The fluid-reduce segment reduction runs 3 passes with (3, 3, 2)
    channels over N = F*K*H incidence rows into L*n_vcs (+1 PAD) link
    sums, and the fused per-flow CC block budgets one HBM round trip
    for its ~40 [F] state vectors.  This is the bandwidth term of the
    hot loop's roofline — the single cost model shared by the fleet
    planner and ``benchmarks/roofline.py``.
    """
    n = n_flows * n_paths * n_hops
    red = sum(c * n * 4 + n * 4 + c * (n_links * n_vcs + 1) * 4
              for c in (3, 3, 2))
    flow = 40 * n_flows * 4
    return float(red + flow)


def estimate_point_cost(scn, n_steps: int, n_vcs: int = 1) -> float:
    """Roofline seconds to advance one (padded) scenario n_steps."""
    F, H = scn.routes.shape
    K = 1 if scn.alt_routes is None else scn.alt_routes.shape[1]
    L = scn.capacity.shape[0]
    return n_steps * fluid_step_bytes(F, K, H, L, n_vcs) / HBM_BW


# ---------------------------------------------------------------------------
# content digests
# ---------------------------------------------------------------------------


def _array_digest(h, name: str, a) -> None:
    if a is None:
        h.update(f"{name}:None".encode())
        return
    a = np.asarray(a)
    h.update(f"{name}:{a.dtype.name}:{a.shape}".encode())
    h.update(np.ascontiguousarray(a).tobytes())


def point_digest(p: SweepPoint) -> str:
    """sha256 of a sweep point's full content (config + scenario)."""
    h = hashlib.sha256()
    h.update(p.name.encode())
    h.update(json.dumps(config_to_dict(p.cfg), sort_keys=True,
                        default=str).encode())
    for name, v in p.scenario._asdict().items():
        if np.ndim(v) == 0 and not isinstance(v, np.ndarray):
            h.update(f"{name}:{v!r}".encode())
        else:
            _array_digest(h, name, v)
    return h.hexdigest()


# ---------------------------------------------------------------------------
# plan dataclasses
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardBucket:
    """One structural bucket: everything that pins the executable.

    All shards of a bucket pad their scenarios to (``n_flows``,
    ``n_hops``, ``n_links``, ``n_paths``), floor the static switch
    count / delay depth / dense rows to the bucket's, and pad the run
    axis to ``width`` — so they share one entry in ``SWEEP_EXEC_CACHE``.
    """

    n_flows: int
    n_hops: int
    n_links: int
    n_paths: int
    n_switches: int
    delay_slots: int
    dense_rows: int
    width: int

    def key(self) -> tuple:
        return dataclasses.astuple(self)


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """A content-addressed unit of fleet work: a few grid points that
    execute as one (padded) sub-sweep launch."""

    index: int                      # position in FleetPlan.shards
    indices: tuple[int, ...]        # rows of the source sweep
    names: tuple[str, ...]
    bucket: int                     # row of FleetPlan.buckets
    cost: float                     # roofline seconds (relative weight)
    digest: str                     # content address (work identity)

    def __len__(self) -> int:
        return len(self.indices)


@dataclasses.dataclass
class FleetPlan:
    """The deterministic execution plan for one fleet run."""

    sweep: Sweep
    n_steps: int | None
    trace_every: int | None
    n_samples: int
    k: int                          # resolved trace_every (steps/window)
    reduce: str
    use_kernels: "bool | str"
    device: object                  # None = the card; "cpu" by request
    temperature: float
    buckets: list[ShardBucket]
    shards: list[ShardSpec]
    digest: str                     # whole-plan content address

    @property
    def total_cost(self) -> float:
        return sum(s.cost for s in self.shards)

    def shard_sweep(self, shard: ShardSpec) -> Sweep:
        """The shard's points as a Sweep, pre-padded to its bucket's
        envelope (so stacking inside ``run`` is a no-op pad)."""
        b = self.buckets[shard.bucket]
        pts = [self.sweep.points[i] for i in shard.indices]
        return Sweep([(p.name, p.cfg,
                       pad_scenario(p.scenario, b.n_flows, b.n_hops,
                                    b.n_links, n_paths=b.n_paths))
                      for p in pts])

    def run_kwargs(self, shard: ShardSpec) -> dict:
        """The exact ``Sweep.run`` kwargs that make this shard execute
        the full batch's program (one signature per bucket)."""
        b = self.buckets[shard.bucket]
        return dict(n_steps=self.n_steps, trace_every=self.trace_every,
                    reduce=self.reduce, use_kernels=self.use_kernels,
                    device=self.device,
                    temperature=self.temperature,
                    pad_runs_to=b.width,
                    min_delay_slots=b.delay_slots,
                    min_switches=b.n_switches,
                    dense_rows=b.dense_rows)

    def summary(self) -> dict:
        return {
            "digest": self.digest,
            "n_points": len(self.sweep.points),
            "n_shards": len(self.shards),
            "n_buckets": len(self.buckets),
            "total_cost_s": round(self.total_cost, 6),
            "shards": [{"index": s.index, "points": list(s.names),
                        "bucket": s.bucket,
                        "cost_s": round(s.cost, 6),
                        "digest": s.digest[:16]}
                       for s in self.shards],
        }


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------


def _lpt_split(indices: list[int], costs: list[float],
               n_shards: int) -> list[list[int]]:
    """Greedy longest-processing-time balance into n_shards bins.

    Deterministic: stable sort by (cost desc, index asc), ties on bin
    load break toward the lowest bin id.
    """
    order = sorted(range(len(indices)),
                   key=lambda i: (-costs[i], indices[i]))
    bins: list[list[int]] = [[] for _ in range(n_shards)]
    loads = [0.0] * n_shards
    for i in order:
        b = min(range(n_shards), key=lambda j: (loads[j], j))
        bins[b].append(indices[i])
        loads[b] += costs[i]
    # keep source order inside a shard (merge order never depends on it,
    # but determinism is easier to eyeball) and drop empty bins
    return [sorted(b) for b in bins if b]


def plan_sweep(sweep: Sweep, n_steps: int | None = None,
               trace_every: int | None = None, *,
               n_shards: int | None = None,
               max_points: int | None = None,
               bucket_by: str = "envelope",
               reduce: str = "fused", use_kernels: "bool | str" = False,
               device=None, temperature: float = 0.0,
               min_delay_slots: int | None = None,
               dense_rows: int | None = None) -> FleetPlan:
    """Cut a sweep into a deterministic, content-addressed FleetPlan.

    ``n_shards`` / ``max_points`` size the decomposition (default: one
    shard per ~4 points); ``bucket_by`` picks the structural grouping:

      * ``"envelope"`` (default) — ONE bucket padded to the global
        shape envelope: every shard shares one executable signature
        and the merged result is bitwise the single ``Sweep.run()``
        launch of the whole grid (the acceptance contract);
      * ``"fabric"`` — bucket by (hops, links, paths, switches): each
        fabric family compiles its own (smaller) program — cheaper per
        step for very ragged grids, still bitwise per point, but the
        executable count is the bucket count.

    ``min_delay_slots`` / ``dense_rows`` floor the corresponding
    static knobs across every bucket (the what-if engine pins these so
    fleet-delegated queries share the serving path's signature).
    ``device`` is where the shards run (None: the card); it is not part
    of the digests, as the reference's work identity has no device.
    """
    pts = sweep.points
    cfg0 = pts[0].cfg
    n_samples, k = _resolve_steps(cfg0, n_steps, trace_every)
    total_steps = n_samples * k
    if bucket_by == "envelope":
        groups = {(): list(range(len(pts)))}
    elif bucket_by == "fabric":
        groups = {}
        for i, p in enumerate(pts):
            s = p.scenario
            K = 1 if s.alt_routes is None else s.alt_routes.shape[1]
            key = (s.routes.shape[1], s.capacity.shape[0], K,
                   s.n_switches)
            groups.setdefault(key, []).append(i)
    else:
        raise ValueError(f"bucket_by must be 'envelope' or 'fabric', "
                         f"got {bucket_by!r}")
    if n_shards is None:
        per = 4 if max_points is None else max(1, int(max_points))
        n_shards = max(1, math.ceil(len(pts) / per))
    n_shards = min(int(n_shards), len(pts))

    # per-group envelope + per-point costs (at the padded shape: cost
    # models the program the shard actually runs, not the ragged input)
    env = {}
    group_cost = {}
    for key, idxs in groups.items():
        scns = [pts[i].scenario for i in idxs]
        F = max(s.routes.shape[0] for s in scns)
        H = max(s.routes.shape[1] for s in scns)
        L = max(s.capacity.shape[0] for s in scns)
        K = max(1 if s.alt_routes is None else s.alt_routes.shape[1]
                for s in scns)
        n_sw = max(s.n_switches for s in scns)
        padded = [pad_scenario(s, F, H, L, n_paths=K) for s in scns]
        D = max(delay_depth(s) for s in padded)
        if min_delay_slots is not None:
            D = max(D, int(min_delay_slots))
        dr = batch_dense_rows(padded, sweep.n_vcs, reduce, dense_rows)
        c = estimate_point_cost(padded[0], total_steps, sweep.n_vcs)
        env[key] = (F, H, L, K, n_sw, D, dr)
        group_cost[key] = c * len(idxs)

    # allocate shard counts proportional to group cost (>= 1 each),
    # then LPT-balance each group's points into its shards
    total = sum(group_cost.values()) or 1.0
    buckets: list[ShardBucket] = []
    shards: list[ShardSpec] = []
    plan_h = hashlib.sha256()
    plan_static = {
        "n_samples": n_samples, "k": k, "dt": float(cfg0.sim.dt),
        "n_vcs": sweep.n_vcs, "reduce": reduce,
        "use_kernels": str(use_kernels), "interpret": False,
        "temperature": float(temperature), "bucket_by": bucket_by,
    }
    plan_h.update(json.dumps(plan_static, sort_keys=True).encode())
    digests = [point_digest(p) for p in pts]
    remaining = n_shards
    keys = sorted(groups, key=lambda key: (-group_cost[key], key))
    for gi, key in enumerate(keys):
        idxs = groups[key]
        left = len(keys) - gi - 1
        want = max(1, round(n_shards * group_cost[key] / total))
        g_shards = min(len(idxs), max(1, min(want, remaining - left)))
        remaining -= g_shards
        F, H, L, K, n_sw, D, dr = env[key]
        c1 = group_cost[key] / len(idxs)
        parts = _lpt_split(idxs, [c1] * len(idxs), g_shards)
        width = max(len(p) for p in parts)
        b = ShardBucket(n_flows=F, n_hops=H, n_links=L, n_paths=K,
                        n_switches=n_sw, delay_slots=D, dense_rows=dr,
                        width=width)
        buckets.append(b)
        for part in parts:
            h = hashlib.sha256()
            h.update(json.dumps(plan_static, sort_keys=True).encode())
            h.update(repr(b.key()).encode())
            for i in part:
                h.update(digests[i].encode())
            shards.append(ShardSpec(
                index=len(shards), indices=tuple(part),
                names=tuple(pts[i].name for i in part),
                bucket=len(buckets) - 1, cost=c1 * len(part),
                digest=h.hexdigest()))
    for s in shards:
        plan_h.update(s.digest.encode())
    return FleetPlan(sweep=sweep, n_steps=n_steps,
                     trace_every=trace_every, n_samples=n_samples, k=k,
                     reduce=reduce, use_kernels=use_kernels,
                     device=device, temperature=temperature,
                     buckets=buckets, shards=shards,
                     digest=plan_h.hexdigest())
