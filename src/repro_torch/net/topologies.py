"""Topology zoo: parametric XGFT / fat-tree and dragonfly fabrics.

Every builder emits the generic directed-link ``Topology`` of
``repro_torch.core.topology`` (one queue per directed link at its sink end),
so any fabric drops straight into the fluid model.  Alongside the
``Topology`` each builder returns an *index* object that knows the
fabric's link-id layout — the routing-table builders in
``repro_torch.net.routing`` consume it, and tests use it to reason about
stages (e.g. per-stage load balance).

XGFT(h; m_1..m_h; w_1..w_h)  (Ohring et al.'s extended generalised fat
tree): level 0 holds the ``prod(m)`` hosts, level ``l`` holds
``prod(m[l:]) * prod(w[:l])`` switches.  A level-(l-1) node has ``w_l``
parents and a level-l node ``m_l`` children, so oversubscription
(tapering) is expressed structurally: ``w_{l+1} < m_l`` gives an
``m_l : w_{l+1}`` taper at level l.  The paper's 64-node CLOS is
XGFT(3; 4,4,4; 1,4,4).

Dragonfly(a, p, h): ``g`` groups of ``a`` routers; each router has
``p`` hosts and ``h`` global ports; routers within a group are fully
connected; each ordered group pair is joined by exactly one global
channel (canonical ``g = a*h + 1`` sizing, smaller ``g`` allowed).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.topology import Topology


def _node_enc(n: int) -> int:
    return -(n + 1)


# ---------------------------------------------------------------------------
# XGFT / fat-tree
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class XGFTIndex:
    """Link-id layout + digit arithmetic for XGFT(h; m; w).

    Link ids: up-links level 1..h first (host->leaf is up level 1),
    then down-links level h..1 (leaf->host is down level 1).  Within a
    level, ``up(l, c, y) = up_base[l] + c * w[l-1] + y`` for level-(l-1)
    node index ``c`` and parent slot ``y`` (and symmetrically for down).
    """

    m: tuple[int, ...]            # down-arities, level 1..h
    w: tuple[int, ...]            # parent multiplicities, level 1..h

    @property
    def h(self) -> int:
        return len(self.m)

    def n_level(self, l: int) -> int:
        """Nodes at level l (0 = hosts)."""
        return math.prod(self.m[l:]) * math.prod(self.w[:l])

    @property
    def n_hosts(self) -> int:
        return self.n_level(0)

    @property
    def n_switches(self) -> int:
        return sum(self.n_level(l) for l in range(1, self.h + 1))

    def switch_id(self, l: int, idx: int) -> int:
        """Global switch id of level-l node ``idx`` (levels stack 1..h)."""
        return sum(self.n_level(j) for j in range(1, l)) + idx

    def up_base(self, l: int) -> int:
        return sum(self.n_level(j - 1) * self.w[j - 1] for j in range(1, l))

    @property
    def dn_base0(self) -> int:
        return self.up_base(self.h + 1)

    def dn_base(self, l: int) -> int:
        """Down-links are laid out level h..1 after all up-links."""
        return self.dn_base0 + sum(
            self.n_level(j) * self.m[j - 1] for j in range(l + 1, self.h + 1))

    def up(self, l: int, child_idx: int, slot: int) -> int:
        return self.up_base(l) + child_idx * self.w[l - 1] + slot

    def dn(self, l: int, parent_idx: int, slot: int) -> int:
        return self.dn_base(l) + parent_idx * self.m[l - 1] + slot

    @property
    def n_links(self) -> int:
        return self.dn_base(1) + self.n_level(1) * self.m[0]

    def up_stage_ids(self, l: int) -> np.ndarray:
        """All up-link ids of level l (for balance diagnostics)."""
        return np.arange(self.up_base(l),
                         self.up_base(l) + self.n_level(l - 1) * self.w[l - 1])

    # -- digit arithmetic ---------------------------------------------------

    def host_digits(self, n: int) -> list[int]:
        """Host id -> [x_1 .. x_h] (x_1 least significant)."""
        out = []
        for ml in self.m:
            out.append(n % ml)
            n //= ml
        return out

    def node_index(self, l: int, x: list[int], y: list[int]) -> int:
        """Level-l node index from digits x_{l+1}..x_h and y_1..y_l.

        ``x`` is the full host digit list (entries <= l ignored); ``y``
        holds the chosen parent slots y_1..y_l (y[j-1] = y_j).
        """
        v = 0
        for j in range(self.h, l, -1):          # x_h .. x_{l+1}
            v = v * self.m[j - 1] + x[j - 1]
        for j in range(l, 0, -1):               # y_l .. y_1
            v = v * self.w[j - 1] + y[j - 1]
        return v


def make_xgft(m: tuple[int, ...], w: tuple[int, ...],
              line_rate: float = 12.5e9,
              name: str | None = None) -> tuple[Topology, XGFTIndex]:
    """XGFT(h; m; w) as a generic directed-link Topology (+ its index).

    ``m[l-1]`` children / ``w[l-1]`` parents per node at each level;
    ``len(m) == len(w)`` levels of switches above the hosts.
    """
    m, w = tuple(int(v) for v in m), tuple(int(v) for v in w)
    if len(m) != len(w) or not m:
        raise ValueError(f"m and w must be equal non-zero length, got "
                         f"{m} / {w}")
    if any(v < 1 for v in m + w):
        raise ValueError(f"arities must be >= 1: m={m} w={w}")
    idx = XGFTIndex(m, w)
    h = idx.h
    L = idx.n_links
    src = np.empty((L,), np.int32)
    dst = np.empty((L,), np.int32)

    def node_ref(l: int, i: int) -> int:
        return _node_enc(i) if l == 0 else idx.switch_id(l, i)

    # enumerate each level's nodes by digits once; connect up and down.
    for l in range(1, h + 1):
        # children at level l-1: digits x_{l}..x_h + y_1..y_{l-1}
        for c in range(idx.n_level(l - 1)):
            # decode child index -> digits (mixed radix, MSB first:
            # x_h..x_l then y_{l-1}..y_1)
            rem = c
            y = [0] * h
            x = [0] * h
            for j in range(1, l):               # y_1 .. y_{l-1} (LSB first)
                y[j - 1] = rem % w[j - 1]
                rem //= w[j - 1]
            for j in range(l, h + 1):           # x_l .. x_h
                x[j - 1] = rem % m[j - 1]
                rem //= m[j - 1]
            for slot in range(w[l - 1]):        # parent slot y_l
                y[l - 1] = slot
                p = idx.node_index(l, x, y)
                lid = idx.up(l, c, slot)
                src[lid] = node_ref(l - 1, c)
                dst[lid] = idx.switch_id(l, p)
                did = idx.dn(l, p, x[l - 1])    # the mirror down-link
                src[did] = idx.switch_id(l, p)
                dst[did] = node_ref(l - 1, c)
    cap = np.full((L,), float(line_rate), np.float64)
    topo = Topology(
        n_nodes=idx.n_hosts, n_switches=idx.n_switches, n_links=L,
        link_src=src, link_dst=dst, link_capacity=cap,
        name=name or f"xgft{m}x{w}")
    return topo, idx


def fat_tree_mw(arity: int, taper: int = 1, levels: int = 3
                ) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(m, w) of the k-ary fat tree with a leaf-stage taper — the one
    definition shared by ``make_fat_tree`` and ``FabricSpec.fat_tree``."""
    if arity % taper:
        raise ValueError(f"taper {taper} must divide arity {arity}")
    m = (arity,) * levels
    w = ((1, arity // taper) + (arity,) * (levels - 2))[:levels]
    return m, w


def make_fat_tree(arity: int = 4, taper: int = 1, levels: int = 3,
                  line_rate: float = 12.5e9) -> tuple[Topology, XGFTIndex]:
    """k-ary fat tree with an optional leaf-stage taper.

    ``taper=1`` is the full-bisection XGFT(levels; a..a; 1,a..a);
    ``taper=2`` halves the leaf uplinks (2:1 oversubscription), etc.
    """
    m, w = fat_tree_mw(arity, taper, levels)
    return make_xgft(m, w, line_rate=line_rate,
                     name=f"ft{arity}^{levels}"
                          + (f"_{taper}to1" if taper > 1 else ""))


# ---------------------------------------------------------------------------
# dragonfly
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DragonflyIndex:
    """Link-id layout for dragonfly(a, p, h) with ``g`` groups.

    Layout: host-up [0, N), host-dn [N, 2N), then per-group local links
    (a*(a-1) ordered router pairs each), then per-group global ports
    (only ports whose peer group exists are materialised; ``gl_port``
    maps (group, peer group) -> link id).
    """

    a: int                        # routers per group
    p: int                        # hosts per router
    h: int                        # global ports per router
    g: int                        # groups

    @property
    def n_hosts(self) -> int:
        return self.g * self.a * self.p

    @property
    def n_switches(self) -> int:
        return self.g * self.a

    def router(self, grp: int, r: int) -> int:
        return grp * self.a + r

    @property
    def local_base(self) -> int:
        return 2 * self.n_hosts

    def local(self, grp: int, r1: int, r2: int) -> int:
        """Directed local link router r1 -> r2 inside ``grp``."""
        slot = r2 - 1 if r2 > r1 else r2
        return (self.local_base + grp * self.a * (self.a - 1)
                + r1 * (self.a - 1) + slot)

    @property
    def global_base(self) -> int:
        return self.local_base + self.g * self.a * (self.a - 1)

    def peer_group(self, grp: int, port: int) -> int:
        """Group reached by global port ``port`` of ``grp`` (may be >= g
        for truncated fabrics — such ports are not materialised)."""
        return port if port < grp else port + 1

    def port_to(self, grp: int, dst_grp: int) -> int:
        """The global port of ``grp`` that reaches ``dst_grp``."""
        return dst_grp if dst_grp < grp else dst_grp - 1

    def gl_owner(self, grp: int, dst_grp: int) -> int:
        """Router of ``grp`` owning the global channel to ``dst_grp``."""
        return self.port_to(grp, dst_grp) // self.h

    def gl_port(self, grp: int, dst_grp: int) -> int:
        """Link id of the global channel ``grp`` -> ``dst_grp``.

        Ports are materialised in (group, port) order, skipping ports
        whose peer group does not exist; with canonical ``g = a*h + 1``
        every port exists and the layout is dense.
        """
        ports_per_group = min(self.g - 1, self.a * self.h)
        return (self.global_base + grp * ports_per_group
                + self.port_to(grp, dst_grp))

    @property
    def n_links(self) -> int:
        ports_per_group = min(self.g - 1, self.a * self.h)
        return self.global_base + self.g * ports_per_group

    def global_ids(self) -> np.ndarray:
        return np.arange(self.global_base, self.n_links)

    def local_ids(self) -> np.ndarray:
        return np.arange(self.local_base, self.global_base)

    # -- reverse lookups (tests + adaptive-routing diagnostics) -------------

    def host_group(self, n: int) -> int:
        return n // (self.a * self.p)

    def host_router(self, n: int) -> int:
        return self.router(self.host_group(n), (n // self.p) % self.a)

    def is_global(self, lid: int) -> bool:
        return self.global_base <= lid < self.n_links

    def global_endpoints(self, lid: int) -> tuple[int, int]:
        """(src group, dst group) of a global channel's link id."""
        if not self.is_global(lid):
            raise ValueError(f"link {lid} is not a global channel")
        ports_per_group = min(self.g - 1, self.a * self.h)
        off = lid - self.global_base
        grp, port = off // ports_per_group, off % ports_per_group
        return grp, self.peer_group(grp, port)

    def groups_visited(self, path: list[int]) -> list[int]:
        """Ordered group sequence a link-id path passes through
        (consecutive duplicates collapsed)."""
        out: list[int] = []
        for lid in path:
            if lid < self.local_base:            # host up/down link
                n = lid if lid < self.n_hosts else lid - self.n_hosts
                grps = [self.host_group(n)]
            elif lid < self.global_base:         # local link
                grps = [(lid - self.local_base) // (self.a * (self.a - 1))]
            else:                                # global channel
                grps = list(self.global_endpoints(lid))
            for grp in grps:
                if not out or out[-1] != grp:
                    out.append(grp)
        return out


def make_dragonfly(a: int = 4, p: int = 2, h: int = 2,
                   groups: int | None = None,
                   line_rate: float = 12.5e9,
                   name: str | None = None
                   ) -> tuple[Topology, DragonflyIndex]:
    """Dragonfly(a, p, h): ``groups`` defaults to the canonical a*h+1."""
    g = a * h + 1 if groups is None else int(groups)
    if not 2 <= g <= a * h + 1:
        raise ValueError(f"groups must be in [2, a*h+1={a*h+1}], got {g}")
    idx = DragonflyIndex(a=a, p=p, h=h, g=g)
    N, L = idx.n_hosts, idx.n_links
    src = np.empty((L,), np.int32)
    dst = np.empty((L,), np.int32)
    for n in range(N):                           # host up / down
        r = idx.router(n // (a * p), (n // p) % a)
        src[n], dst[n] = _node_enc(n), r
        src[N + n], dst[N + n] = r, _node_enc(n)
    for grp in range(g):                         # local full mesh
        for r1 in range(a):
            for r2 in range(a):
                if r1 == r2:
                    continue
                lid = idx.local(grp, r1, r2)
                src[lid] = idx.router(grp, r1)
                dst[lid] = idx.router(grp, r2)
    for grp in range(g):                         # global channels
        for dg in range(g):
            if dg == grp:
                continue
            lid = idx.gl_port(grp, dg)
            src[lid] = idx.router(grp, idx.gl_owner(grp, dg))
            dst[lid] = idx.router(dg, idx.gl_owner(dg, grp))
    cap = np.full((L,), float(line_rate), np.float64)
    topo = Topology(
        n_nodes=N, n_switches=idx.n_switches, n_links=L,
        link_src=src, link_dst=dst, link_capacity=cap,
        name=name or f"dfly_a{a}p{p}h{h}g{g}")
    return topo, idx
