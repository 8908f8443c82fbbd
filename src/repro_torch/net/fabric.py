"""FabricSpec — declarative, hashable fabric descriptions.

A ``FabricSpec`` names a topology family + its parameters as plain
data, so it can sit inside a (frozen, hashable) ``ScenarioSpec`` and
key jit/result caches.  ``build`` / ``route_table`` materialise the
``Topology`` and its validated ``RouteTable`` once per (spec,
line_rate) — sweeping 3 CC schemes over one fabric builds its table a
single time.  ``route_set(k, seed)`` is the multi-path analogue
(minimal + Valiant detour candidates, cached per (spec, k, seed)) that
adaptive routing modes select from at run time.

Families:
  * ``clos3``      — the paper's 3-stage CLOS (closed-form D-mod-K,
                     materialised as a table; ``roll`` picks the wiring)
  * ``xgft``       — XGFT(h; m; w) with arbitrary arities / tapering
  * ``fat_tree``   — sugar: k-ary 3-level XGFT with a leaf taper
  * ``dragonfly``  — dragonfly(a, p, h[, groups]), minimal routing
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro_torch.core.topology import Topology, make_clos3

from .routing import (RouteSet, RouteTable, clos_route_set,
                      clos_route_table, dragonfly_route_set,
                      dragonfly_route_table, validate_route_set,
                      validate_table, xgft_route_set, xgft_route_table)
from .topologies import (DragonflyIndex, XGFTIndex, fat_tree_mw,
                         make_dragonfly, make_xgft)


@dataclasses.dataclass(frozen=True)
class FabricSpec:
    """One fabric as plain data; ``build``/``route_table`` are cached."""

    kind: str = "clos3"           # clos3 | xgft | dragonfly
    arity: int = 4                # clos3
    roll: int = 0                 # D-mod-K digit roll (clos3 / xgft)
    m: tuple[int, ...] = ()       # xgft down-arities
    w: tuple[int, ...] = ()       # xgft parent multiplicities
    a: int = 4                    # dragonfly routers / group
    p: int = 2                    # dragonfly hosts / router
    h: int = 2                    # dragonfly global ports / router
    groups: int | None = None     # dragonfly groups (None = a*h + 1)
    # per-link capacity heterogeneity: (link class -> rate multiplier)
    # pairs, applied to ``Topology.link_capacity`` at build.  Classes:
    # XGFT/CLOS ``up1..uph`` / ``dn1..dnh`` (level 1 = host edge);
    # dragonfly ``hostup`` / ``hostdn`` / ``local`` / ``global``.
    # Empty = uniform (bitwise identical to the pre-heterogeneity
    # builds).  Use ``with_rates(up2=4.0)`` to construct.
    rate_scales: tuple[tuple[str, float], ...] = ()

    # -- constructors -------------------------------------------------------

    @classmethod
    def clos3(cls, arity: int = 4, roll: int = 0) -> "FabricSpec":
        return cls(kind="clos3", arity=arity, roll=roll)

    @classmethod
    def xgft(cls, m, w, roll: int = 0) -> "FabricSpec":
        return cls(kind="xgft", m=tuple(int(v) for v in m),
                   w=tuple(int(v) for v in w), roll=roll)

    @classmethod
    def fat_tree(cls, arity: int = 4, taper: int = 1, levels: int = 3,
                 roll: int = 0) -> "FabricSpec":
        """k-ary fat tree; ``taper=2`` gives 2:1 leaf oversubscription."""
        return cls.xgft(*fat_tree_mw(arity, taper, levels), roll=roll)

    @classmethod
    def dragonfly(cls, a: int = 4, p: int = 2, h: int = 2,
                  groups: int | None = None) -> "FabricSpec":
        return cls(kind="dragonfly", a=a, p=p, h=h, groups=groups)

    def with_rates(self, **scales: float) -> "FabricSpec":
        """Per-link-class capacity multipliers (heterogeneous fabrics).

        ``FabricSpec.fat_tree(4).with_rates(up2=4.0, dn2=4.0)`` models
        fast uplinks (hosts at 1x, leaf->spine wires at 4x);
        ``with_rates(global_=0.5)`` (note the trailing underscore for
        the python keyword) halves dragonfly global channels.  Scales
        compose with earlier ones; the class names are validated at
        build time against the fabric family.
        """
        merged = dict(self.rate_scales)
        for k, v in scales.items():
            key = k.rstrip("_")
            merged[key] = merged.get(key, 1.0) * float(v)
        return dataclasses.replace(
            self, rate_scales=tuple(sorted(merged.items())))

    # -- materialisation ----------------------------------------------------

    @property
    def name(self) -> str:
        if self.kind == "clos3":
            base = f"clos{self.arity ** 3}" + \
                (f"_r{self.roll}" if self.roll else "")
        elif self.kind == "xgft":
            base = ("xgft" + "x".join(map(str, self.m)) + "_w"
                    + "x".join(map(str, self.w)))
        else:
            g = self.a * self.h + 1 if self.groups is None else self.groups
            base = f"dfly_a{self.a}p{self.p}h{self.h}g{g}"
        for cls, scale in self.rate_scales:
            base += f"+{cls}x{scale:g}"
        return base

    @property
    def n_nodes(self) -> int:
        if self.kind == "clos3":
            return self.arity ** 3
        if self.kind == "xgft":
            n = 1
            for v in self.m:
                n *= v
            return n
        g = self.a * self.h + 1 if self.groups is None else self.groups
        return g * self.a * self.p

    def build(self, line_rate: float = 12.5e9) -> Topology:
        return _build_topo(self, float(line_rate))

    @property
    def _structural(self) -> "FabricSpec":
        """This fabric with capacity scales stripped — routing is pure
        structure, so scaled variants share the unscaled spec's route
        caches instead of rebuilding O(N^2 * H) tables."""
        if not self.rate_scales:
            return self
        return dataclasses.replace(self, rate_scales=())

    def route_table(self) -> RouteTable:
        """The fabric's validated route table.

        Tables are pure structure — link *ids*, not capacities — so the
        cache is keyed on the structural spec alone; sweeping line
        rates or per-class capacity scales never rebuilds the table.
        """
        return _build_table(self._structural)

    def route_set(self, k_paths: int = 4, seed: int = 0) -> RouteSet:
        """K-candidate multi-path routes (slot 0 minimal, 1..K-1
        Valiant detours); validated + cached per (spec, k, seed)."""
        return _build_route_set(self._structural, int(k_paths), int(seed))

    def flow_routes(self, pairs) -> "np.ndarray":
        """[F, H_MAX] minimal routes for (src, dst) pairs, cached per
        (spec hash, pairs) — a sweep's grid points share one extraction
        (and, downstream, one device upload + one incidence sort).
        Treat as read-only: the array is shared across callers.
        """
        return _flow_routes(self._structural,
                            tuple(tuple(p) for p in pairs))

    def flow_route_set(self, pairs, k_paths: int = 4, seed: int = 0):
        """([F, K, H_MAX] candidate routes, [F, K] hops) for pairs,
        cached per (spec hash, pairs, k, seed); read-only like
        ``flow_routes``."""
        return _flow_route_set(self._structural,
                               tuple(tuple(p) for p in pairs),
                               int(k_paths), int(seed))


def _link_class_ids(spec: FabricSpec) -> "dict[str, np.ndarray]":
    """Link ids per named class, for the per-class capacity scales.

    XGFT/CLOS expose one class per stage and direction (``up1`` = host
    edge up, ``up2`` = leaf uplinks, ..., ``dnl`` the mirror);
    dragonfly exposes ``hostup`` / ``hostdn`` / ``local`` / ``global``.
    """
    if spec.kind == "clos3":
        a3 = spec.arity ** 3
        seg = lambda i: np.arange(i * a3, (i + 1) * a3)
        return {"up1": seg(0), "up2": seg(1), "up3": seg(2),
                "dn3": seg(3), "dn2": seg(4), "dn1": seg(5)}
    if spec.kind == "xgft":
        idx = XGFTIndex(spec.m, spec.w)      # pure digit arithmetic —
        out = {}                             # no topology materialised
        for l in range(1, idx.h + 1):
            out[f"up{l}"] = idx.up_stage_ids(l)
            n_dn = idx.n_level(l) * idx.m[l - 1]
            out[f"dn{l}"] = np.arange(idx.dn_base(l),
                                      idx.dn_base(l) + n_dn)
        return out
    if spec.kind == "dragonfly":
        g = spec.a * spec.h + 1 if spec.groups is None else spec.groups
        idx = DragonflyIndex(a=spec.a, p=spec.p, h=spec.h, g=g)
        n = idx.n_hosts
        return {"hostup": np.arange(0, n),
                "hostdn": np.arange(n, 2 * n),
                "local": idx.local_ids(),
                "global": idx.global_ids()}
    raise ValueError(f"unknown fabric kind: {spec.kind!r}")


def _apply_rate_scales(spec: FabricSpec, topo: Topology) -> Topology:
    if not spec.rate_scales:
        return topo                  # uniform fabrics: untouched arrays
    classes = _link_class_ids(spec)
    cap = topo.link_capacity.copy()
    for cls, scale in spec.rate_scales:
        if cls not in classes:
            raise ValueError(
                f"unknown link class {cls!r} for {spec.kind} fabric; "
                f"available: {sorted(classes)}")
        cap[classes[cls]] *= scale
    return dataclasses.replace(topo, link_capacity=cap)


@functools.lru_cache(maxsize=64)
def _build_topo(spec: FabricSpec, line_rate: float) -> Topology:
    """Materialise one fabric's Topology; cached per (spec, line_rate).

    ``spec.rate_scales`` multiplies whole link classes (tapered or
    accelerated uplinks, slow global channels); the scaled capacities
    thread through ``Scenario.capacity`` into ``ScenarioDev.cap_ext``
    untouched, so heterogeneity costs the fluid loop nothing.  The
    returned arrays are shared across callers — treat as read-only.
    """
    if spec.kind == "clos3":
        topo = make_clos3(arity=spec.arity, line_rate=line_rate,
                          name=spec.name)
    elif spec.kind == "xgft":
        topo = make_xgft(spec.m, spec.w, line_rate=line_rate,
                         name=spec.name)[0]
    elif spec.kind == "dragonfly":
        topo = make_dragonfly(spec.a, spec.p, spec.h, groups=spec.groups,
                              line_rate=line_rate, name=spec.name)[0]
    else:
        raise ValueError(f"unknown fabric kind: {spec.kind!r}")
    return _apply_rate_scales(spec, topo)


@functools.lru_cache(maxsize=64)
def _build_table(spec: FabricSpec) -> RouteTable:
    """Build + validate one fabric's route table; cached per spec."""
    if spec.kind == "clos3":
        table = clos_route_table(spec.arity, roll=spec.roll)
    elif spec.kind == "xgft":
        _, idx = make_xgft(spec.m, spec.w)
        table = xgft_route_table(idx, roll=spec.roll)
    elif spec.kind == "dragonfly":
        _, idx = make_dragonfly(spec.a, spec.p, spec.h,
                                groups=spec.groups)
        table = dragonfly_route_table(idx)
    else:
        raise ValueError(f"unknown fabric kind: {spec.kind!r}")
    validate_table(_build_topo(spec, 12.5e9), table)
    return table


def _frozen(a: np.ndarray) -> np.ndarray:
    """Cached arrays are shared across callers; make 'read-only' real —
    an in-place edit raises instead of corrupting every later build."""
    a.setflags(write=False)
    return a


@functools.lru_cache(maxsize=256)
def _flow_routes(spec: FabricSpec, pairs: tuple):
    return _frozen(_build_table(spec).routes_for_pairs(pairs))


@functools.lru_cache(maxsize=256)
def _flow_route_set(spec: FabricSpec, pairs: tuple, k: int, seed: int):
    rset = _build_route_set(spec, k, seed)
    return (_frozen(rset.routes_for_pairs(pairs)),
            _frozen(rset.hops_for_pairs(pairs)))


@functools.lru_cache(maxsize=64)
def _build_route_set(spec: FabricSpec, k: int, seed: int) -> RouteSet:
    """Build + validate one fabric's multi-path RouteSet; cached."""
    if spec.kind == "clos3":
        rset = clos_route_set(spec.arity, k=k, seed=seed, roll=spec.roll)
    elif spec.kind == "xgft":
        _, idx = make_xgft(spec.m, spec.w)
        rset = xgft_route_set(idx, k=k, seed=seed, roll=spec.roll)
    elif spec.kind == "dragonfly":
        _, idx = make_dragonfly(spec.a, spec.p, spec.h, groups=spec.groups)
        rset = dragonfly_route_set(idx, k=k, seed=seed)
    else:
        raise ValueError(f"unknown fabric kind: {spec.kind!r}")
    validate_route_set(_build_topo(spec, 12.5e9), rset)
    return rset
