"""Table-driven routing: precomputed per-(src,dst) padded link-id paths.

The general routing path of the repo: every fabric family provides a
*table builder* that emits a ``RouteTable`` — a dense
``[N, N, H_MAX]`` int32 array of directed-link ids (PAD = -1, trailing)
with per-pair hop counts — and every scenario then routes by table
lookup (``routes_for_pairs``).  ``H_MAX`` varies by fabric (2h for an
h-level XGFT, 5 for a dragonfly), replacing the CLOS-only hardwired
``H_MAX = 6``; the fluid model is shape-polymorphic in hops, and mixed
fabrics pad to a common H when stacked into one Sweep.

The closed-form CLOS D-mod-K of ``repro_torch.core.routing`` survives as one
table builder among several (``clos_route_table``) — same link ids,
same wirings (``roll``), just materialised once per fabric instead of
recomputed per flow.

``validate_table`` is the vectorised validity checker every builder is
held to: paths start at the source host, end at the destination host,
consecutive links share a switch, and padding is trailing-only.

Multi-path routing generalises the table to a ``RouteSet`` — K
candidate paths per pair ([N, N, K, H_MAX]): slot 0 is the minimal
path, slots 1..K-1 are Valiant/VLB detours (random spine for CLOS,
random root for XGFT, random intermediate group for dragonfly).  The
fluid loop selects among candidates at run time (``min`` pins slot 0,
``valiant`` pins a sampled detour, ``ugal`` compares queue-weighted
hop costs — see ``repro_torch.core.fluid``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.routing import PAD, assign_vc, clos_route, link_incidence
from repro_torch.core.topology import ClosIndex, Topology

from .topologies import DragonflyIndex, XGFTIndex


def _pair_index(pairs, n_nodes: int) -> np.ndarray:
    """Validate (src, dst) pairs into an [F, 2] host-id index."""
    idx = np.asarray(pairs, np.int64)
    if idx.ndim != 2 or idx.shape[1] != 2:
        raise ValueError(f"pairs must be [F, 2], got {idx.shape}")
    if (idx < 0).any() or (idx >= n_nodes).any():
        raise ValueError(
            f"pair endpoints must be host ids in [0, {n_nodes})")
    return idx


@dataclasses.dataclass(frozen=True)
class RouteTable:
    """Dense per-(src,dst) padded link-id paths for one fabric.

    ``paths[s, d, :hops[s, d]]`` are real link ids; the rest is PAD.
    ``paths[s, s]`` is all-PAD (no self-traffic).
    """

    paths: np.ndarray             # [N, N, H_MAX] int32, PAD-padded
    hops: np.ndarray              # [N, N] int32

    @property
    def n_nodes(self) -> int:
        return self.paths.shape[0]

    @property
    def h_max(self) -> int:
        return self.paths.shape[2]

    def routes_for_pairs(self, pairs) -> np.ndarray:
        """[F, H_MAX] int32 route matrix for (src, dst) pairs."""
        if not len(pairs):
            return np.empty((0, self.h_max), np.int32)
        idx = _pair_index(pairs, self.n_nodes)
        return self.paths[idx[:, 0], idx[:, 1]].copy()

    def hops_for_pairs(self, pairs) -> np.ndarray:
        """[F] int32 hop counts for (src, dst) pairs."""
        if not len(pairs):
            return np.empty((0,), np.int32)
        idx = _pair_index(pairs, self.n_nodes)
        return self.hops[idx[:, 0], idx[:, 1]].copy()

    def link_load(self, n_links: int,
                  pairs=None) -> np.ndarray:
        """Flow-routes crossing each link (all-to-all, or given pairs).

        Real hops are selected by each path's hop *count*, not by
        scanning for the PAD sentinel: tables whose paths have unequal
        lengths may legally carry anything (stale ids, scratch slots)
        beyond ``hops[s, d]``, and counting those slots silently
        inflated the load of whichever link id the padding aliased.
        """
        if pairs is None:
            routes = self.paths.reshape(-1, self.h_max)
            hops = self.hops.reshape(-1)
        else:
            routes = self.routes_for_pairs(pairs)
            hops = self.hops_for_pairs(pairs)
        mask = np.arange(self.h_max)[None, :] < hops[:, None]
        ids = routes[mask]
        return np.bincount(ids, minlength=n_links).astype(np.int64)

    def incidence(self, n_links: int, pairs=None):
        """Link-sorted (flow, hop) incidence of this table's routes.

        ``(perm, seg, offsets)`` per ``repro_torch.core.routing
        .link_incidence``.  For a single-path scenario built from the
        same ``pairs`` this is exactly the ``ScenarioDev.red_perm`` /
        ``red_seg`` / ``red_off`` layout the fluid loop's fused
        reductions tile by (cross-checked in tests/test_fluid_fused) —
        the host-side view for inspecting load skew (``offsets`` row
        lengths size the dense-CSR engine) without building a scenario.
        """
        routes = (self.paths.reshape(-1, self.h_max) if pairs is None
                  else self.routes_for_pairs(pairs))
        return link_incidence(routes[:, None, :], n_links)


def _from_path_fn(n: int, h_max: int, path_fn) -> RouteTable:
    """Materialise ``path_fn(s, d) -> list[int]`` into a RouteTable."""
    paths = np.full((n, n, h_max), PAD, np.int32)
    hops = np.zeros((n, n), np.int32)
    for s in range(n):
        for d in range(n):
            if s == d:
                continue
            p = path_fn(s, d)
            if len(p) > h_max:
                raise ValueError(
                    f"path {s}->{d} has {len(p)} hops > H_MAX={h_max}")
            paths[s, d, : len(p)] = p
            hops[s, d] = len(p)
    return RouteTable(paths=paths, hops=hops)


@dataclasses.dataclass(frozen=True)
class RouteSet:
    """Multi-path routes: K candidate paths per (src, dst) pair.

    ``paths[s, d, k, :hops[s, d, k]]`` are real link ids; slot ``k = 0``
    is always the fabric's minimal (deterministic) path, slots
    ``1..K-1`` are the Valiant/VLB detour candidates.  Every slot of an
    ``s != d`` pair holds a *valid* path — builders that cannot detour
    a pair (e.g. same-leaf XGFT) fall back to the minimal path for that
    slot, so selection logic never has to special-case missing
    candidates.  A ``RouteTable`` is the ``K = 1`` degenerate case
    (``minimal`` recovers it; ``slot(k)`` views any candidate layer).
    """

    paths: np.ndarray             # [N, N, K, H_MAX] int32, PAD-padded
    hops: np.ndarray              # [N, N, K] int32

    @property
    def n_nodes(self) -> int:
        return self.paths.shape[0]

    @property
    def k_paths(self) -> int:
        return self.paths.shape[2]

    @property
    def h_max(self) -> int:
        return self.paths.shape[3]

    def slot(self, k: int) -> RouteTable:
        """Candidate layer ``k`` as a single-path RouteTable view."""
        return RouteTable(paths=self.paths[:, :, k], hops=self.hops[:, :, k])

    @property
    def minimal(self) -> RouteTable:
        return self.slot(0)

    def routes_for_pairs(self, pairs) -> np.ndarray:
        """[F, K, H_MAX] int32 candidate routes for (src, dst) pairs."""
        if not len(pairs):
            return np.empty((0, self.k_paths, self.h_max), np.int32)
        idx = _pair_index(pairs, self.n_nodes)
        return self.paths[idx[:, 0], idx[:, 1]].copy()

    def hops_for_pairs(self, pairs) -> np.ndarray:
        """[F, K] int32 per-candidate hop counts."""
        if not len(pairs):
            return np.empty((0, self.k_paths), np.int32)
        idx = _pair_index(pairs, self.n_nodes)
        return self.hops[idx[:, 0], idx[:, 1]].copy()

    def vc_for_pairs(self, pairs, n_vcs: int,
                     mode: str = "slot") -> np.ndarray:
        """[F, K, H_MAX] int32 static VC per candidate hop.

        The per-VC fluid model (``LinkParams.n_vcs > 1``) splits every
        wire's input buffer into independent queues; this is where the
        route set decides which queue each candidate path rides.
        ``mode="slot"`` (default) keeps minimal traffic on VC 0 and
        puts Valiant/UGAL detours on VC 1 — detoured flows stop
        sharing hop queues (and pause state) with minimal flows;
        ``mode="hop"`` escalates the VC along the path (dateline-style
        credit-loop avoidance for dragonfly cycles).  See
        ``repro_torch.core.routing.assign_vc`` for the exact rule.
        """
        return assign_vc(self.routes_for_pairs(pairs), n_vcs, mode=mode)

    def link_load(self, n_links: int, pairs=None,
                  k: int | None = None) -> np.ndarray:
        """Flow-routes crossing each link; ``k`` selects one candidate
        layer (None sums all K layers, hop-count-masked)."""
        if k is not None:
            return self.slot(k).link_load(n_links, pairs=pairs)
        return sum(self.slot(j).link_load(n_links, pairs=pairs)
                   for j in range(self.k_paths))

    def incidence(self, n_links: int, pairs=None):
        """Link-sorted (flow, slot, hop) incidence over ALL K candidate
        layers — for a ``pairs`` scenario with ``n_paths == K`` this is
        exactly the [F*K*H] ``ScenarioDev.red_*`` layout the fluid loop
        reduces at run time (unselected slots contribute exact zeros).
        See ``RouteTable.incidence``.
        """
        routes = (self.paths.reshape(-1, self.k_paths, self.h_max)
                  if pairs is None else self.routes_for_pairs(pairs))
        return link_incidence(routes, n_links)


def _rng_for(seed: int, s: int, d: int, k: int) -> np.random.RandomState:
    """Independent, order-free stream per (seed, src, dst, slot)."""
    return np.random.RandomState(
        np.array([seed & 0x7FFFFFFF, s, d, k], np.uint32))


def _route_set_from_fns(n: int, h_max: int, k: int, seed: int,
                        min_fn, alt_fn) -> RouteSet:
    """Assemble a RouteSet: slot 0 = ``min_fn(s, d)``; slots 1..k-1 =
    ``alt_fn(s, d, rng)`` with a deterministic per-(s, d, slot) rng."""
    if k < 1:
        raise ValueError(f"need k >= 1 candidate paths, got {k}")
    paths = np.full((n, n, k, h_max), PAD, np.int32)
    hops = np.zeros((n, n, k), np.int32)
    for s in range(n):
        for d in range(n):
            if s == d:
                continue
            for j in range(k):
                p = min_fn(s, d) if j == 0 else \
                    alt_fn(s, d, _rng_for(seed, s, d, j))
                if len(p) > h_max:
                    raise ValueError(
                        f"path {s}->{d} slot {j} has {len(p)} hops "
                        f"> H_MAX={h_max}")
                paths[s, d, j, : len(p)] = p
                hops[s, d, j] = len(p)
    return RouteSet(paths=paths, hops=hops)


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------


def clos_route_table(arity: int = 4, roll: int = 0) -> RouteTable:
    """The 3-stage CLOS closed form, materialised as a table (H_MAX=6)."""
    idx = ClosIndex(arity)
    n = arity ** 3
    return _from_path_fn(n, 6, lambda s, d: clos_route(idx, s, d, roll=roll))


def xgft_path(idx: XGFTIndex, s: int, d: int, roll: int = 0) -> list[int]:
    """Deterministic D-mod-K up-down path in XGFT(h; m; w).

    Ascends to the lowest common ancestor level L (highest host digit
    where s and d differ); the up-link slot at each level j is a
    destination digit — ``(d // W[(j-1+roll) % h]) % w_j`` with
    ``W[k] = prod(w[:k])`` — so all-to-all traffic spreads evenly over
    every up stage; the down path is forced by d's digits.
    """
    if s == d:
        return []
    h, m, w = idx.h, idx.m, idx.w
    sx, dx = idx.host_digits(s), idx.host_digits(d)
    L = max(j for j in range(1, h + 1) if sx[j - 1] != dx[j - 1])
    W = [1]
    for j in range(1, h):
        W.append(W[-1] * w[j - 1])
    path = []
    y = [0] * h
    cur = s                                     # level-0 index = host id
    for j in range(1, L + 1):                   # ascend, choosing y_j
        y[j - 1] = (d // W[(j - 1 + roll) % h]) % w[j - 1]
        path.append(idx.up(j, cur, y[j - 1]))
        cur = idx.node_index(j, sx, y)
    for j in range(L, 0, -1):                   # descend along d's digits
        path.append(idx.dn(j, cur, dx[j - 1]))
        # the level-(j-1) child has d's x-digits at every position >= j
        # (above L they equal s's) and the ascent's y-digits below j
        cur = idx.node_index(j - 1, dx, y)
    return path


def xgft_route_table(idx: XGFTIndex, roll: int = 0) -> RouteTable:
    """D-mod-K table for an XGFT; H_MAX = 2 * levels."""
    return _from_path_fn(idx.n_hosts, 2 * idx.h,
                         lambda s, d: xgft_path(idx, s, d, roll=roll))


def dragonfly_path(idx: DragonflyIndex, s: int, d: int) -> list[int]:
    """Minimal dragonfly route: local -> global -> local (<= 5 links)."""
    if s == d:
        return []
    a, p = idx.a, idx.p
    rs, rd = (s // p) % a, (d // p) % a
    gs, gd = s // (a * p), d // (a * p)
    up, dn = s, idx.n_hosts + d
    if gs == gd:
        if rs == rd:
            return [up, dn]
        return [up, idx.local(gs, rs, rd), dn]
    path = [up]
    gw = idx.gl_owner(gs, gd)                   # gateway router in gs
    if rs != gw:
        path.append(idx.local(gs, rs, gw))
    path.append(idx.gl_port(gs, gd))
    rin = idx.gl_owner(gd, gs)                  # arrival router in gd
    if rin != rd:
        path.append(idx.local(gd, rin, rd))
    path.append(dn)
    return path


def dragonfly_route_table(idx: DragonflyIndex) -> RouteTable:
    """Minimal-route table for a dragonfly; H_MAX = 5."""
    return _from_path_fn(idx.n_hosts, 5,
                         lambda s, d: dragonfly_path(idx, s, d))


# ---------------------------------------------------------------------------
# Valiant (VLB) detour candidates + multi-path route sets
# ---------------------------------------------------------------------------


def clos_valiant_path(idx: ClosIndex, s: int, d: int,
                      rng: np.random.RandomState) -> list[int]:
    """Randomised up-route through the 3-stage CLOS.

    The CLOS is single-length up-down, so "Valiant" degenerates to a
    random spine (random digit selectors u0, u1 instead of D-mod-K):
    same hop count, different — congestion-decorrelated — middle links.
    Same-leaf pairs have a forced path and fall back to it.
    """
    a = idx.arity
    if s == d:
        return []
    s_leaf, d_leaf = s // a, d // a
    s_grp, d_grp = s_leaf // a, d_leaf // a
    path = [idx.nic_up(s)]
    if d_leaf == s_leaf:                        # forced: no detour exists
        path.append(idx.leaf_dn(d))
        return path
    u0 = int(rng.randint(a))
    path.append(idx.leaf_up(s_leaf, u0))
    if d_grp == s_grp:
        path.append(idx.agg_dn(s_grp, u0, d_leaf % a))
        path.append(idx.leaf_dn(d))
        return path
    u1 = int(rng.randint(a))
    path.append(idx.agg_up(s_grp, u0, u1))
    path.append(idx.spine_dn(u0 * a + u1, d_grp))
    path.append(idx.agg_dn(d_grp, u0, d_leaf % a))
    path.append(idx.leaf_dn(d))
    return path


def xgft_valiant_path(idx: XGFTIndex, s: int, d: int,
                      rng: np.random.RandomState) -> list[int]:
    """VLB detour in XGFT(h; m; w): ascend all the way to a *random*
    root (uniform parent slot at every level), then descend along d's
    digits — the fat-tree form of "route to a random intermediate",
    since the root choice fixes the intermediate subtree.  Always 2h
    links (non-minimal whenever the true LCA is below the roots)."""
    if s == d:
        return []
    h = idx.h
    sx, dx = idx.host_digits(s), idx.host_digits(d)
    path = []
    y = [0] * h
    cur = s
    for j in range(1, h + 1):                   # ascend with random slots
        y[j - 1] = int(rng.randint(idx.w[j - 1]))
        path.append(idx.up(j, cur, y[j - 1]))
        cur = idx.node_index(j, sx, y)
    for j in range(h, 0, -1):                   # descend along d's digits
        path.append(idx.dn(j, cur, dx[j - 1]))
        cur = idx.node_index(j - 1, dx, y)
    return path


def dragonfly_valiant_path(idx: DragonflyIndex, s: int, d: int,
                           rng: np.random.RandomState) -> list[int]:
    """VLB detour in a dragonfly: route minimally to a random
    *intermediate group* (neither source nor destination group), then
    minimally on to the destination — two global hops, <= 7 links.
    Intra-group pairs detour via a random intermediate router instead;
    pairs with no possible detour fall back to the minimal path.
    """
    if s == d:
        return []
    a, p = idx.a, idx.p
    rs, rd = (s // p) % a, (d // p) % a
    gs, gd = s // (a * p), d // (a * p)
    up, dn = s, idx.n_hosts + d
    if gs == gd:                                # in-group router detour
        cand = [r for r in range(a) if r not in (rs, rd)]
        if not cand:
            return dragonfly_path(idx, s, d)
        ri = cand[int(rng.randint(len(cand)))]
        return [up, idx.local(gs, rs, ri), idx.local(gs, ri, rd), dn]
    cand = [g for g in range(idx.g) if g not in (gs, gd)]
    if not cand:
        return dragonfly_path(idx, s, d)
    gi = cand[int(rng.randint(len(cand)))]
    path = [up]
    gw = idx.gl_owner(gs, gi)                   # leg 1: gs -> gi
    if rs != gw:
        path.append(idx.local(gs, rs, gw))
    path.append(idx.gl_port(gs, gi))
    rin = idx.gl_owner(gi, gs)
    gw2 = idx.gl_owner(gi, gd)                  # leg 2: gi -> gd
    if rin != gw2:
        path.append(idx.local(gi, rin, gw2))
    path.append(idx.gl_port(gi, gd))
    rin2 = idx.gl_owner(gd, gi)
    if rin2 != rd:
        path.append(idx.local(gd, rin2, rd))
    path.append(dn)
    return path


DFLY_VLB_H_MAX = 7        # up + local + global + local + global + local + dn


def clos_route_set(arity: int = 4, k: int = 4, seed: int = 0,
                   roll: int = 0) -> RouteSet:
    """Minimal D-mod-K + k-1 random-spine candidates; H_MAX = 6."""
    idx = ClosIndex(arity)
    return _route_set_from_fns(
        arity ** 3, 6, k, seed,
        lambda s, d: clos_route(idx, s, d, roll=roll),
        lambda s, d, rng: clos_valiant_path(idx, s, d, rng))


def xgft_route_set(idx: XGFTIndex, k: int = 4, seed: int = 0,
                   roll: int = 0) -> RouteSet:
    """Minimal D-mod-K + k-1 random-root VLB candidates; H_MAX = 2h."""
    return _route_set_from_fns(
        idx.n_hosts, 2 * idx.h, k, seed,
        lambda s, d: xgft_path(idx, s, d, roll=roll),
        lambda s, d, rng: xgft_valiant_path(idx, s, d, rng))


def dragonfly_route_set(idx: DragonflyIndex, k: int = 4,
                        seed: int = 0) -> RouteSet:
    """Minimal + k-1 intermediate-group VLB candidates; H_MAX = 7
    (the VLB worst case) once any detour slot exists, else 5."""
    h_max = DFLY_VLB_H_MAX if k > 1 else 5
    return _route_set_from_fns(
        idx.n_hosts, h_max, k, seed,
        lambda s, d: dragonfly_path(idx, s, d),
        lambda s, d, rng: dragonfly_valiant_path(idx, s, d, rng))


# ---------------------------------------------------------------------------
# validity checking
# ---------------------------------------------------------------------------


def validate_table(topo: Topology, table: RouteTable) -> None:
    """Structural validity of a full route table (vectorised).

    Raises AssertionError unless, for every (s, d) pair with s != d:
    the first link leaves host s, the last link delivers to host d,
    consecutive links share a switch (sink(h) == source(h+1)), all
    link ids are in range, and padding is trailing-only.
    """
    n, h = table.n_nodes, table.h_max
    paths, hops = table.paths, table.hops
    if topo.n_nodes != n:
        raise AssertionError(
            f"table is for {n} hosts, topology has {topo.n_nodes}")
    valid = paths != PAD
    # trailing-only padding, and hops consistent with the mask
    want = np.arange(h)[None, None, :] < hops[..., None]
    if not (valid == want).all():
        raise AssertionError("non-trailing PAD or hops/path mismatch")
    off = ~np.eye(n, dtype=bool)
    if not (hops[off] >= 2).all() or (hops.diagonal() != 0).any():
        raise AssertionError("every s != d path needs >= 2 links "
                             "(host up + host down); s == s must be empty")
    ids = paths[valid]
    if ids.size and (ids.min() < 0 or ids.max() >= topo.n_links):
        raise AssertionError("link id out of range")
    # endpoint checks
    s_idx, d_idx = np.nonzero(off)
    first = paths[s_idx, d_idx, 0]
    last = paths[s_idx, d_idx, hops[s_idx, d_idx] - 1]
    if not (topo.link_src[first] == -(s_idx + 1)).all():
        bad = int(np.argmax(topo.link_src[first] != -(s_idx + 1)))
        raise AssertionError(
            f"path {s_idx[bad]}->{d_idx[bad]} does not start at its "
            f"source host")
    if not (topo.link_dst[last] == -(d_idx + 1)).all():
        bad = int(np.argmax(topo.link_dst[last] != -(d_idx + 1)))
        raise AssertionError(
            f"path {s_idx[bad]}->{d_idx[bad]} does not sink at its "
            f"destination host")
    # consecutive links share a switch
    a, b = paths[..., :-1], paths[..., 1:]
    both = (a != PAD) & (b != PAD)
    sink = topo.link_dst[np.where(both, a, 0)]
    srcn = topo.link_src[np.where(both, b, 0)]
    ok = ~both | ((sink == srcn) & (sink >= 0))
    if not ok.all():
        s, d, j = (int(x[0]) for x in np.nonzero(~ok))
        raise AssertionError(
            f"path {s}->{d}: hop {j} sinks at {topo.link_dst[paths[s,d,j]]}"
            f" but hop {j+1} departs {topo.link_src[paths[s,d,j+1]]}")


def validate_route_set(topo: Topology, rset: RouteSet) -> None:
    """Every candidate layer of a RouteSet passes ``validate_table``.

    Builders guarantee each slot of an ``s != d`` pair holds a complete
    valid path (detour or minimal fallback), so the single-table checker
    applies verbatim per layer.
    """
    for k in range(rset.k_paths):
        try:
            validate_table(topo, rset.slot(k))
        except AssertionError as e:
            raise AssertionError(f"candidate layer {k}: {e}") from e


def stage_balance(load: np.ndarray, ids: np.ndarray) -> tuple[int, int]:
    """(min, max) flow load over one stage's link ids."""
    sel = load[ids]
    return int(sel.min()), int(sel.max())
