"""repro_torch.net — topology zoo + table-driven routing for the CC model.

The scenario-generation subsystem: parametric fabrics (XGFT/fat-tree
with tapering, dragonfly) emitting the generic directed-link
``Topology``, and per-(src,dst) precomputed route tables with a
validity checker.  Combine with ``repro_torch.core.workloads`` and feed the
result to ``repro_torch.core.experiments.Sweep`` for one-jit batched
(fabric x workload x scheme) evaluation.

    from repro_torch.net import FabricSpec
    from repro_torch.core import ScenarioSpec, Sweep

    fab = FabricSpec.dragonfly(a=4, p=2, h=2)     # 72 hosts, 9 groups
    spec = ScenarioSpec.incast(8, dst=0, fabric=fab)
    Sweep.grid(configs={...}, scenarios={"dfly": spec}).run()
"""

from .fabric import FabricSpec
from .routing import (RouteSet, RouteTable, clos_route_set,
                      clos_route_table, clos_valiant_path,
                      dragonfly_path, dragonfly_route_set,
                      dragonfly_route_table, dragonfly_valiant_path,
                      stage_balance, validate_route_set, validate_table,
                      xgft_path, xgft_route_set, xgft_route_table,
                      xgft_valiant_path)
from .topologies import (DragonflyIndex, XGFTIndex, make_dragonfly,
                         make_fat_tree, make_xgft)

__all__ = [
    "FabricSpec", "RouteSet", "RouteTable", "clos_route_set",
    "clos_route_table", "clos_valiant_path", "dragonfly_path",
    "dragonfly_route_set", "dragonfly_route_table",
    "dragonfly_valiant_path", "stage_balance", "validate_route_set",
    "validate_table", "xgft_path", "xgft_route_set", "xgft_route_table",
    "xgft_valiant_path", "DragonflyIndex", "XGFTIndex",
    "make_dragonfly", "make_fat_tree", "make_xgft",
]
