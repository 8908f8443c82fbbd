"""Deterministic D-mod-K routing over the 3-stage CLOS.

The paper: "we have also modeled a deterministic routing similar to
D-mod-K, which balances the routes of the flows so that the links at a
given stage are crossed by a similar number of flow routes."

For the 3-stage CLOS with arity ``a`` and destination node ``d``:

* at the leaf, the uplink is chosen as ``d mod a``;
* at the agg, the uplink (spine digit) is ``(d // a) mod a``.

With the paper's flows this puts F0,F1 (→N16) and F3 (→N12) on the *same*
leaf-0 uplink (16 mod 4 == 12 mod 4 == 0), i.e. they share the wire into
the input buffer of switch 16 — exactly the HoL scene of §II.  The
alternative selector (``roll=1``) uses digit ``(d // a) mod a`` at the
leaf, which makes the victim's path wire-disjoint from the congesting
flows (needed to reach Fig. 2's 25 GB/s aggregate — see DESIGN.md §4 for
why both wirings are provided).

Routes are returned as padded link-id sequences ``[H_MAX]`` with -1
padding; H_MAX = 6 covers the worst case nic→leaf→agg→spine→agg→leaf→node.
"""

from __future__ import annotations

import numpy as np

from .topology import ClosIndex, Topology

H_MAX = 6
PAD = -1


def clos_route(idx: ClosIndex, src: int, dst: int, roll: int = 0) -> list[int]:
    """Directed-link id sequence for src node -> dst node (D-mod-K)."""
    a = idx.arity
    if roll not in (0, 1):
        raise ValueError(f"roll must be 0 or 1, got {roll}")
    if src == dst:
        return []
    s_leaf, d_leaf = src // a, dst // a
    s_grp, d_grp = s_leaf // a, d_leaf // a
    # digit selectors for up-path balancing: roll rotates which base-a
    # digit of dst picks each stage's uplink.
    # roll=0: leaf uses dst%a,     agg uses (dst//a)%a.
    # roll=1: leaf uses (dst//a)%a, agg uses dst%a  (swapped).
    digit0 = (dst // (a ** roll)) % a            # leaf uplink choice
    digit1 = (dst // (a ** (1 - roll))) % a      # agg uplink (spine digit)

    path = [idx.nic_up(src)]
    if d_leaf == s_leaf:
        path.append(idx.leaf_dn(dst))
        return path
    u0 = digit0
    path.append(idx.leaf_up(s_leaf, u0))         # -> agg(s_grp, u0)
    if d_grp == s_grp:
        path.append(idx.agg_dn(s_grp, u0, d_leaf % a))
        path.append(idx.leaf_dn(dst))
        return path
    u1 = digit1
    spine = u0 * a + u1
    path.append(idx.agg_up(s_grp, u0, u1))       # -> spine u0*a+u1
    path.append(idx.spine_dn(spine, d_grp))      # -> agg(d_grp, u0)
    path.append(idx.agg_dn(d_grp, u0, d_leaf % a))
    path.append(idx.leaf_dn(dst))
    return path


def build_flow_routes(topo: Topology, pairs: list[tuple[int, int]],
                      arity: int = 4, roll: int = 0) -> np.ndarray:
    """[F, H_MAX] int32 link-id matrix (PAD-filled) for (src,dst) pairs."""
    idx = ClosIndex(arity)
    routes = np.full((len(pairs), H_MAX), PAD, dtype=np.int32)
    for f, (s, d) in enumerate(pairs):
        p = clos_route(idx, s, d, roll=roll)
        if len(p) > H_MAX:
            raise ValueError(f"path longer than H_MAX for flow {f}: {p}")
        routes[f, : len(p)] = p
    return routes


def route_hops(routes: np.ndarray) -> np.ndarray:
    """Number of real hops per flow."""
    return (routes != PAD).sum(axis=1).astype(np.int32)


def validate_routes(topo: Topology, routes: np.ndarray) -> None:
    """Each consecutive link pair must share an entity (sink == src)."""
    for f in range(routes.shape[0]):
        hops = [h for h in routes[f] if h != PAD]
        for i in range(len(hops) - 1):
            if topo.link_dst[hops[i]] != topo.link_src[hops[i + 1]]:
                raise AssertionError(
                    f"flow {f}: link {hops[i]} sink "
                    f"{topo.link_dst[hops[i]]} != link {hops[i+1]} src "
                    f"{topo.link_src[hops[i+1]]}")


def link_incidence(alt_routes: np.ndarray, n_links: int,
                   vc: np.ndarray | None = None, n_vcs: int = 1
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sorted (flow, path, hop) -> link incidence for fused reductions.

    ``alt_routes`` is the [F, K, H] candidate stack (PAD = -1).  The
    flattened (f, k, h) entries are stably sorted by link id (PAD maps
    to the scratch segment ``n_links``), which turns every per-link
    scatter-add of the fluid step into ONE gather + sorted segment sum:
    the stable sort keeps each link's contributors in flattened (f, k,
    h) order, so sequential segment accumulation is bit-identical to
    the legacy ``.at[widx].add`` path.

    With ``n_vcs > 1`` the segment key becomes the *(link, VC) queue*
    ``link * n_vcs + vc[f, k, h]`` (``vc`` same shape as
    ``alt_routes``, values in [0, n_vcs)), so every per-queue sum of
    the per-VC fluid model rides the same single pass; PAD entries map
    to the scratch segment ``n_links * n_vcs`` regardless of their VC.
    At ``n_vcs = 1`` the key degenerates to the link id — the identical
    stable sort, hence the identical permutation and accumulation
    order, which is what keeps the single-VC model bitwise unchanged.

    Returns ``(perm, seg, offsets)`` with ``S = n_links * n_vcs``:
      * ``perm``    [F*K*H] int32 — gather order into the sorted layout
      * ``seg``     [F*K*H] int32 — sorted segment (queue) id per entry
      * ``offsets`` [S + 2] int32 — CSR row pointers: entries of queue
        q live at ``perm[offsets[q]:offsets[q + 1]]`` (segment ``S`` is
        the PAD scratch)
    """
    flat = alt_routes.reshape(-1).astype(np.int64)
    n_seg = n_links * n_vcs
    if n_vcs == 1 or vc is None:
        seg = np.where(flat == PAD, n_seg, flat * n_vcs)
    else:
        vflat = vc.reshape(-1).astype(np.int64)
        if vc.shape != alt_routes.shape:
            raise ValueError(f"vc shape {vc.shape} != routes shape "
                             f"{alt_routes.shape}")
        if ((vflat < 0) | (vflat >= n_vcs)).any():
            raise ValueError(f"vc entries must lie in [0, {n_vcs})")
        seg = np.where(flat == PAD, n_seg, flat * n_vcs + vflat)
    perm = np.argsort(seg, kind="stable").astype(np.int32)
    seg_sorted = seg[perm].astype(np.int32)
    offsets = np.zeros((n_seg + 2,), np.int64)
    np.add.at(offsets, seg_sorted + 1, 1)
    return perm, seg_sorted, np.cumsum(offsets).astype(np.int32)


def assign_vc(alt_routes: np.ndarray, n_vcs: int,
              mode: str = "slot",
              flow_vc: np.ndarray | None = None) -> np.ndarray:
    """Static VC assignment for a [F, K, H] candidate stack.

    ``mode`` picks the rule (both clip to the available ``n_vcs``):
      * ``"slot"`` — candidate slot 0 (the minimal path) rides VC 0,
        detour slots ride VC 1: Valiant/UGAL traffic stops sharing hop
        queues (and PFC pause state) with minimal traffic — the
        twice-deferred per-VC separation from the ROADMAP.
      * ``"hop"``  — VC escalates with hop index (``min(h, n_vcs-1)``),
        the classic dateline/credit-loop deadlock-avoidance discipline
        for torus/dragonfly cycles: a flow re-entering a previously
        used wire does so on a higher VC, breaking the cyclic buffer
        dependency that a pause storm needs to wedge.

    ``flow_vc`` ([F] ints, optional) overrides the rule per flow on
    every hop/slot — how a scenario pins e.g. a victim flow to its own
    lane.  PAD hops are forced to VC 0 so the incidence scratch mapping
    stays exact.  ``n_vcs = 1`` returns all-zeros (the single-queue
    model).
    """
    if mode not in ("slot", "hop"):
        raise ValueError(f"vc mode must be 'slot' or 'hop', got {mode!r}")
    F, K, H = alt_routes.shape
    if mode == "slot":
        vc = np.where(np.arange(K, dtype=np.int32)[None, :, None] > 0,
                      min(1, n_vcs - 1), 0)
        vc = np.broadcast_to(vc, (F, K, H))
    else:
        vc = np.broadcast_to(
            np.minimum(np.arange(H, dtype=np.int32), n_vcs - 1)
            [None, None, :], (F, K, H))
    if flow_vc is not None:
        fv = np.minimum(np.asarray(flow_vc, np.int32), n_vcs - 1)
        if fv.shape != (F,):
            raise ValueError(f"flow_vc must be [{F}], got {fv.shape}")
        if (fv < 0).any():
            raise ValueError("flow_vc entries must be >= 0")
        vc = np.broadcast_to(fv[:, None, None], (F, K, H))
    return np.where(alt_routes == PAD, 0, vc).astype(np.int32)


def stage_load(routes: np.ndarray, n_links: int) -> np.ndarray:
    """How many flow routes cross each link (balance diagnostic)."""
    load = np.zeros((n_links,), dtype=np.int64)
    for f in range(routes.shape[0]):
        for h in routes[f]:
            if h != PAD:
                load[h] += 1
    return load
