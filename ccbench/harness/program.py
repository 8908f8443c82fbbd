"""The system under test: a cell's grid as the port's ``Sweep`` objects.

Only this module (and the metric readers' counters) touches the program,
``repro_torch``: it turns the cell's data into ``FabricSpec``,
``ScenarioSpec`` and ``CCSpec`` values, builds the grid once (the scenario
build), and hands each sweep of the window a ``Sweep`` over those built
scenarios with that sweep's constants.
"""

from __future__ import annotations

import time


def _spec(cell, stack, params: dict):
    from repro_torch.core import params as P
    sim = dict(params["sim"], trace_every=cell.trace_every)
    return P.CCSpec(marking=stack[0], notification=stack[1],
                    reaction=stack[2], routing="min",
                    link=P.LinkParams(**params["link"]),
                    dcqcn=P.DCQCNParams(**params["dcqcn"]),
                    rev=P.RevParams(**params["rev"]),
                    fncc=P.FNCCParams(**params["fncc"]),
                    swift=P.SwiftParams(**params["swift"]),
                    sim=P.SimParams(**sim))


def _fabric(config: dict, roll: int):
    from repro_torch.net import FabricSpec
    fab = config["fabric"]
    if fab["kind"] == "clos3":
        return FabricSpec.clos3(arity=fab["arity"], roll=roll)
    return FabricSpec.dragonfly(fab["a"], fab["p"], fab["h"],
                                groups=fab.get("groups"))


def _scenario_spec(config: dict, roll: int, scene: dict):
    from repro_torch.core import ScenarioSpec
    return ScenarioSpec(
        kind="flowspec", fabric=_fabric(config, roll),
        flow_src=tuple(scene["src"]), flow_dst=tuple(scene["dst"]),
        flow_t_start=tuple(scene["t_start"]),
        flow_t_stop=tuple(scene["t_stop"]),
        flow_volume=tuple(scene["volume"]),
        flow_rate=tuple(-float(f) for f in scene["rate_frac"]),
        nic_buffer=float(scene["nic_buffer"]),
        flow_victim=tuple(bool(v) for v in scene["victim"]),
        label=scene["name"])


class Grid:
    """The cell's runs as the program sees them."""

    def __init__(self, cell):
        from repro_torch.core import Sweep
        self.cell = cell
        t0 = time.perf_counter()
        base = cell.params(1.0)
        self.base = Sweep([
            (name, _spec(cell, stack, base),
             _scenario_spec(cell.config, roll, cell.scenes[roll][i]))
            for name, stack, roll, i in cell.points])
        self.build_s = time.perf_counter() - t0

    def sweep(self, scale: float):
        """A sweep of every run at the parameter point ``scale``."""
        from repro_torch.core import Sweep
        params = self.cell.params(scale)
        return Sweep([(pt.name, _spec(self.cell, stack, params), pt.scenario)
                      for pt, (_, stack, _, _) in zip(self.base.points,
                                                      self.cell.points)])

    def run_kw(self, device=None) -> dict:
        cell = self.cell
        return dict(n_steps=cell.steps, trace_every=cell.trace_every,
                    use_kernels="mega" if cell.tier == "mega" else False,
                    device=device)

    def link_ends(self, roll: int):
        """(link_src, link_dst) of the program's fabric for ``roll``."""
        cfg = self.base.points[0].cfg
        topo = _fabric(self.cell.config, roll).build(
            line_rate=cfg.link.line_rate)
        return topo.link_src, topo.link_dst
