"""Plain NumPy fabrics and minimal routes for the benchmark's reference.

Two families, numbered as the paper's model numbers them:

* ``clos3(arity, roll)`` -- the 3-stage folded CLOS of the paper's section
  II (arity 4: 64 hosts, 48 switches, 384 directed links), routed
  destination-mod-k, ``roll`` choosing which digit of the destination picks
  the leaf and the aggregation uplink.
* ``dragonfly(a, p, h, groups)`` -- Kim et al., ISCA 2008: ``groups`` groups
  of ``a`` routers in a full local mesh, ``p`` hosts and ``h`` global ports
  a router, routed minimally (local, global, local).

A host ``n`` is the entity ``-(n + 1)``; switches are ``0 ..
n_switches - 1``.  Each directed link has a source entity, a sink entity
and a capacity.  A route is the list of link ids from the source host's
uplink to the destination host's downlink.
"""

from __future__ import annotations

import dataclasses

import numpy as np

PAD = -1


@dataclasses.dataclass(frozen=True)
class Fabric:
    n_hosts: int
    n_switches: int
    link_src: np.ndarray          # [L] int32 entity
    link_dst: np.ndarray          # [L] int32 entity
    h_max: int                    # route width
    route: object                 # (src host, dst host) -> [link ids]

    @property
    def n_links(self) -> int:
        return int(self.link_src.shape[0])

    def sink_switch(self) -> np.ndarray:
        return np.where(self.link_dst >= 0, self.link_dst, -1).astype(
            np.int32)

    def routes(self, src, dst) -> np.ndarray:
        """[F, h_max] int32 link ids, PAD-filled."""
        out = np.full((len(src), self.h_max), PAD, np.int32)
        for f, (s, d) in enumerate(zip(src, dst)):
            path = self.route(int(s), int(d))
            out[f, :len(path)] = path
        return out

    def entity_path(self, route_row) -> tuple:
        """A route as its (source, sink) entity pairs: comparable across
        two numberings of the same fabric."""
        return tuple((int(self.link_src[l]), int(self.link_dst[l]))
                     for l in route_row if l != PAD)


def _host(n: int) -> int:
    return -(n + 1)


def clos3(arity: int = 4, roll: int = 0) -> Fabric:
    a = arity
    a3 = a ** 3
    n_leaf = n_agg = n_spine = a * a

    def agg(g, p):
        return n_leaf + g * a + p

    def spine(s):
        return n_leaf + n_agg + s

    src, dst = [], []
    for n in range(a3):                            # host up
        src.append(_host(n)), dst.append(n // a)
    for leaf in range(n_leaf):                     # leaf up
        for u in range(a):
            src.append(leaf), dst.append(agg(leaf // a, u))
    for g in range(a):                             # aggregation up
        for p in range(a):
            for u in range(a):
                src.append(agg(g, p)), dst.append(spine(p * a + u))
    for s in range(n_spine):                       # spine down
        for g in range(a):
            src.append(spine(s)), dst.append(agg(g, s // a))
    for g in range(a):                             # aggregation down
        for p in range(a):
            for j in range(a):
                src.append(agg(g, p)), dst.append(g * a + j)
    for n in range(a3):                            # leaf down
        src.append(n // a), dst.append(_host(n))

    def leaf_up(leaf, u):
        return a3 + leaf * a + u

    def agg_up(g, p, u):
        return 2 * a3 + (g * a + p) * a + u

    def spine_dn(s, g):
        return 3 * a3 + s * a + g

    def agg_dn(g, p, j):
        return 4 * a3 + (g * a + p) * a + j

    def route(s, d):
        if s == d:
            return []
        s_leaf, d_leaf = s // a, d // a
        s_grp, d_grp = s_leaf // a, d_leaf // a
        u0 = (d // (a ** roll)) % a
        u1 = (d // (a ** (1 - roll))) % a
        path = [s]
        if d_leaf == s_leaf:
            return path + [5 * a3 + d]
        path.append(leaf_up(s_leaf, u0))
        if d_grp == s_grp:
            return path + [agg_dn(s_grp, u0, d_leaf % a), 5 * a3 + d]
        return path + [agg_up(s_grp, u0, u1), spine_dn(u0 * a + u1, d_grp),
                       agg_dn(d_grp, u0, d_leaf % a), 5 * a3 + d]

    return Fabric(n_hosts=a3, n_switches=3 * a * a,
                  link_src=np.asarray(src, np.int32),
                  link_dst=np.asarray(dst, np.int32), h_max=6, route=route)


def dragonfly(a: int, p: int, h: int, groups: int | None = None) -> Fabric:
    g = a * h + 1 if groups is None else int(groups)
    n = g * a * p
    local_base = 2 * n
    global_base = local_base + g * a * (a - 1)
    ports = min(g - 1, a * h)

    def router(grp, r):
        return grp * a + r

    def local(grp, r1, r2):
        return local_base + grp * a * (a - 1) + r1 * (a - 1) + \
            (r2 - 1 if r2 > r1 else r2)

    def port_to(grp, dg):
        return dg if dg < grp else dg - 1

    def owner(grp, dg):
        return port_to(grp, dg) // h

    def gl(grp, dg):
        return global_base + grp * ports + port_to(grp, dg)

    n_links = global_base + g * ports
    src = np.empty((n_links,), np.int32)
    dst = np.empty((n_links,), np.int32)
    for x in range(n):
        r = router(x // (a * p), (x // p) % a)
        src[x], dst[x] = _host(x), r
        src[n + x], dst[n + x] = r, _host(x)
    for grp in range(g):
        for r1 in range(a):
            for r2 in range(a):
                if r1 != r2:
                    lid = local(grp, r1, r2)
                    src[lid], dst[lid] = router(grp, r1), router(grp, r2)
    for grp in range(g):
        for dg in range(g):
            if dg != grp:
                lid = gl(grp, dg)
                src[lid] = router(grp, owner(grp, dg))
                dst[lid] = router(dg, owner(dg, grp))

    def route(s, d):
        if s == d:
            return []
        rs, rd = (s // p) % a, (d // p) % a
        gs, gd = s // (a * p), d // (a * p)
        up, dn = s, n + d
        if gs == gd:
            return [up, dn] if rs == rd else [up, local(gs, rs, rd), dn]
        path = [up]
        gw = owner(gs, gd)
        if rs != gw:
            path.append(local(gs, rs, gw))
        path.append(gl(gs, gd))
        rin = owner(gd, gs)
        if rin != rd:
            path.append(local(gd, rin, rd))
        return path + [dn]

    return Fabric(n_hosts=n, n_switches=g * a, link_src=src, link_dst=dst,
                  h_max=5, route=route)


def build(spec: dict, roll: int = 0) -> Fabric:
    """A fabric from a configuration's ``fabric`` entry."""
    if spec["kind"] == "clos3":
        return clos3(spec["arity"], roll)
    if spec["kind"] == "dragonfly":
        return dragonfly(spec["a"], spec["p"], spec["h"], spec.get("groups"))
    raise ValueError(f"unknown fabric kind {spec['kind']!r}")
