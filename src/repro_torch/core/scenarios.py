"""Legacy scenario builders — thin wrappers over ``ScenarioSpec``.

The declarative ``repro_torch.core.experiments.ScenarioSpec`` is the public
entrypoint (it composes with ``Sweep`` for one-jit batched evaluation);
these functions survive as conveniences for single-run callers and keep
the seed API stable.  Each is ``ScenarioSpec.<ctor>(...).build(cfg)``.
"""

from __future__ import annotations

import numpy as np

from .experiments import ScenarioSpec
from .fluid import Scenario
from .params import CCConfig

PAPER_FLOW_NAMES = ["F0", "F1", "F4", "F8", "F3(victim)"]


def paper_incast(cfg: CCConfig, roll: int = 0,
                 nic_buffer: float = 4e6) -> Scenario:
    """The paper's §II.A scenario on the 64-node CLOS.

    Flows (order matters for figures):
      0: F0 N0->N16   (congesting, shares leaf-0 uplink-0 wire)
      1: F1 N1->N16   (congesting, same wire)
      2: F4 N4->N16   (congesting)
      3: F8 N8->N16   (congesting)
      4: F3 N3->N12   (victim)

    All generators open at 1 ms and close at 3 ms at line rate.
    roll=0 reproduces the Fig. 3 narrative (victim shares the wire into
    switch 16); roll=1 the Fig. 2 aggregate (victim wire-disjoint).
    """
    return ScenarioSpec.paper_incast(
        roll=roll, nic_buffer=nic_buffer).build(cfg)


def paper_incast_volume(cfg: CCConfig, roll: int = 0,
                        volume_bytes: float = 9.375e6) -> Scenario:
    """Equal-work variant of the paper scenario for completion-time runs.

    Every flow carries a fixed volume (default: the 9.375 MB a fair-shared
    incast source admits during the paper's 1->3 ms window) and sources
    stay open until done, so completion times are comparable across CC
    schemes — this is the variant behind the 4 / 6.5 / 12.5 ms ordering.
    """
    return ScenarioSpec.paper_incast_volume(
        roll=roll, volume_bytes=volume_bytes).build(cfg)


def incast(cfg: CCConfig, n_senders: int, dst: int = 16, *,
           victim: bool = True, arity: int = 4, roll: int = 0,
           t_start: float = 1e-3, t_stop: float = 3e-3) -> Scenario:
    """Parametric n-to-1 incast with an optional victim flow."""
    return ScenarioSpec.incast(
        n_senders, dst, victim=victim, arity=arity, roll=roll,
        t_start=t_start, t_stop=t_stop).build(cfg)


def random_permutation(cfg: CCConfig, n_flows: int, seed: int = 0, *,
                       arity: int = 4, t_start: float = 0.1e-3,
                       t_stop: float = 2e-3) -> Scenario:
    """Uniform random permutation traffic (DC-scale stress)."""
    return ScenarioSpec.permutation(
        n_flows, seed, arity=arity, t_start=t_start,
        t_stop=t_stop).build(cfg)


def collective_flows(cfg: CCConfig, pairs: list[tuple[int, int]],
                     bytes_per_flow: float, *, arity: int = 4,
                     t_start: float = 0.0) -> Scenario:
    """Flows carrying a fixed volume (for co-simulating training traffic).

    Completion under each CC scheme is then the collective's finish time
    on the modelled fabric.
    """
    return ScenarioSpec.flows(
        pairs, arity=arity, t_start=t_start, t_stop=float("inf"),
        volume=float(bytes_per_flow),
        nic_buffer=2 * bytes_per_flow).build(cfg)
