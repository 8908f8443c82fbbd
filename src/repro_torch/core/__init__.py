"""repro_torch.core — the fluid CC model on PyTorch (port of repro.core).

Public surface (as the reference's, for the ported slice):
  * params:      CCConfig / CCScheme / CCSpec / PAPER_CONFIG
  * cc:          the MARKING / NOTIFICATION / REACTION stage registries
  * topology / routing: the CLOS builders and the link incidence
  * fluid:       Scenario / FluidState / fluid_step / make_step_fn
  * simulator:   run / run_all_schemes / SimResult
  * exec_cache:  CacheStats / ExecutableCache; experiments'
                 SWEEP_EXEC_CACHE holds each batch structure's captured
                 trace window
  * experiments: ScenarioSpec / Sweep / SweepResult / config_grid
  * scenarios / workloads: the reference's host-side builders
"""

from .params import (CCConfig, CCScheme, CCSpec, DCQCNParams, FNCCParams,
                     LinkParams, PAPER_CONFIG, ROUTING_MODES, RevParams,
                     SimParams, SwiftParams)
from . import cc
from .topology import ClosIndex, Topology, make_clos3, make_paper_clos
from .routing import (build_flow_routes, clos_route, link_incidence,
                      route_hops)
from .fluid import (FluidState, Scenario, ScenarioDev, StepParams,
                    delay_depth, dense_reduce_rows, fluid_step,
                    init_state, make_step_fn, scenario_device,
                    step_params)
from .simulator import SimResult, run, run_all_schemes
from .exec_cache import CacheStats, ExecutableCache
from .experiments import (SWEEP_EXEC_CACHE, ScenarioSpec, Sweep,
                          SweepResult, config_grid, pad_scenario,
                          stack_scenarios, trim_final)
from .scenarios import (PAPER_FLOW_NAMES, collective_flows, incast,
                        paper_incast, paper_incast_volume,
                        random_permutation)
from .workloads import Workload
from . import workloads

__all__ = [
    "CCConfig", "CCScheme", "CCSpec", "DCQCNParams", "FNCCParams",
    "LinkParams", "PAPER_CONFIG", "ROUTING_MODES", "RevParams",
    "SimParams", "SwiftParams", "cc",
    "ClosIndex", "Topology", "make_clos3", "make_paper_clos",
    "build_flow_routes", "clos_route", "link_incidence", "route_hops",
    "FluidState", "Scenario", "ScenarioDev", "StepParams", "delay_depth",
    "dense_reduce_rows", "fluid_step", "init_state", "make_step_fn",
    "scenario_device", "step_params", "SimResult", "run",
    "run_all_schemes", "CacheStats", "ExecutableCache",
    "SWEEP_EXEC_CACHE",
    "ScenarioSpec", "Sweep", "SweepResult", "config_grid",
    "pad_scenario", "stack_scenarios", "trim_final", "PAPER_FLOW_NAMES",
    "collective_flows", "incast", "paper_incast", "paper_incast_volume",
    "random_permutation", "Workload", "workloads",
]
