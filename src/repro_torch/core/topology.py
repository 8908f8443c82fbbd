"""CLOS / XGFT topology builder for the congestion-control fluid model.

The paper evaluates a 64-node, 3-stage CLOS built from 48 radix-8 switches
(Fig. 1).  That is exactly XGFT(3; 4,4,4; 1,4,4):

* 16 leaf switches  (ids 0..15),  4 down-ports to nodes, 4 up-ports,
* 16 middle (agg) switches (ids 16..31) — the paper's "switch 16" is
  agg(group=0, pos=0), which is where the incast HoL forms,
* 16 spine switches (ids 32..47), 4 down-ports used.

Nodes are *blocked* onto leaves (node n -> leaf n // 4), which places
N0,N1,N3 on leaf 0 as the paper's narrative requires.

Queueing model: every **directed link** carries one queue at its *sink*
end — i.e. the input buffer of the downstream switch (InfiniBand-style
input-buffered switches; the paper explicitly describes HoL at "the input
buffer of switch 16").  A link is *paused* (PFC) when its own sink-side
queue crosses XOFF, which stops all flows crossing that wire — the HoL
mechanism.

Link id layout for the 64-node CLOS (L = 384 directed links):
    [0,   64)   nic-up:    node n        -> leaf n//4        (queue at leaf)
    [64, 128)   leaf-up:   leaf l, up u  -> agg(l//4, u)     (queue at agg)
    [128,192)   agg-up:    agg(g,p), u   -> spine p*4+u      (queue at spine)
    [192,256)   spine-dn:  spine s -> agg(g, s//4) for g     (queue at agg)
    [256,320)   agg-dn:    agg(g,p) -> leaf g*4+j            (queue at leaf)
    [320,384)   leaf-dn:   leaf l -> node (delivery)         (queue at node)

Everything is returned as plain numpy arrays inside a frozen ``Topology``;
the fluid model converts them to device arrays once per scenario.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Topology:
    """A directed-link network description (generic, not CLOS-specific)."""

    n_nodes: int
    n_switches: int
    n_links: int
    # per directed link: source entity and sink entity. Switches are ids in
    # [0, n_switches); nodes are encoded as -(node_id + 1); so src/dst < 0
    # means a host NIC endpoint.
    link_src: np.ndarray          # [L] int32
    link_dst: np.ndarray          # [L] int32
    link_capacity: np.ndarray     # [L] float64, bytes/s
    name: str = "generic"

    # -- convenience masks -------------------------------------------------
    def sink_switch(self) -> np.ndarray:
        """Switch id owning each link's sink-side queue (-1 for host sinks)."""
        d = self.link_dst
        return np.where(d >= 0, d, -1).astype(np.int32)

    def is_delivery_link(self) -> np.ndarray:
        return (self.link_dst < 0)


# --------------------------------------------------------------------------
# 64-node 3-stage CLOS (the paper's Fig. 1) and its k-ary generalisation.
# --------------------------------------------------------------------------


def _node_enc(n: int) -> int:
    return -(n + 1)


def make_clos3(arity: int = 4, line_rate: float = 12.5e9,
               name: str = "clos64") -> Topology:
    """3-stage folded CLOS, XGFT(3; a,a,a; 1,a,a) with ``a = arity``.

    arity=4 gives the paper's 64-node / 48-switch / radix-8 network.
    Total: nodes = a^3, leaves = a^2, aggs = a^2, spines = a^2,
    directed links = 6 * a^3.
    """
    a = arity
    n_nodes = a ** 3
    n_leaf = a * a
    n_agg = a * a
    n_spine = a * a
    n_switches = n_leaf + n_agg + n_spine

    def leaf_id(l: int) -> int:
        return l

    def agg_id(g: int, p: int) -> int:
        return n_leaf + g * a + p

    def spine_id(s: int) -> int:
        return n_leaf + n_agg + s

    src, dst = [], []

    # [0, a^3): nic-up, node n -> leaf n//a
    for n in range(n_nodes):
        src.append(_node_enc(n))
        dst.append(leaf_id(n // a))
    # [a^3, 2a^3): leaf-up, leaf l uplink u -> agg(l//a, u)
    for l in range(n_leaf):
        for u in range(a):
            src.append(leaf_id(l))
            dst.append(agg_id(l // a, u))
    # [2a^3, 3a^3): agg-up, agg(g,p) uplink u -> spine p*a + u
    for g in range(a):
        for p in range(a):
            for u in range(a):
                src.append(agg_id(g, p))
                dst.append(spine_id(p * a + u))
    # [3a^3, 4a^3): spine-dn, spine s -> agg(g, s//a) for each group g
    for s in range(n_spine):
        for g in range(a):
            src.append(spine_id(s))
            dst.append(agg_id(g, s // a))
    # [4a^3, 5a^3): agg-dn, agg(g,p) -> leaf g*a + j
    for g in range(a):
        for p in range(a):
            for j in range(a):
                src.append(agg_id(g, p))
                dst.append(leaf_id(g * a + j))
    # [5a^3, 6a^3): leaf-dn, leaf l -> node (delivery)
    for n in range(n_nodes):
        src.append(leaf_id(n // a))
        dst.append(_node_enc(n))

    src_a = np.asarray(src, dtype=np.int32)
    dst_a = np.asarray(dst, dtype=np.int32)
    cap = np.full(src_a.shape, float(line_rate), dtype=np.float64)
    return Topology(
        n_nodes=n_nodes,
        n_switches=n_switches,
        n_links=len(src),
        link_src=src_a,
        link_dst=dst_a,
        link_capacity=cap,
        name=name,
    )


def make_paper_clos(line_rate: float = 12.5e9) -> Topology:
    """The exact network of the paper's §II.A: 64 nodes, 48 switches."""
    return make_clos3(arity=4, line_rate=line_rate, name="paper-clos64")


# Link-id helpers for the 3-stage CLOS (used by routing + tests) -----------


@dataclasses.dataclass(frozen=True)
class ClosIndex:
    arity: int

    @property
    def a3(self) -> int:
        return self.arity ** 3

    def nic_up(self, node: int) -> int:
        return node

    def leaf_up(self, leaf: int, u: int) -> int:
        return self.a3 + leaf * self.arity + u

    def agg_up(self, g: int, p: int, u: int) -> int:
        a = self.arity
        return 2 * self.a3 + (g * a + p) * a + u

    def spine_dn(self, s: int, g: int) -> int:
        return 3 * self.a3 + s * self.arity + g

    def agg_dn(self, g: int, p: int, j: int) -> int:
        a = self.arity
        return 4 * self.a3 + (g * a + p) * a + j

    def leaf_dn(self, node: int) -> int:
        return 5 * self.a3 + node

    def switch_of_agg(self, g: int, p: int) -> int:
        """Global switch id of agg(g,p); paper's 'switch 16' is (0,0)."""
        a = self.arity
        return a * a + g * a + p
