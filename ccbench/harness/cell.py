"""A cell, found by name: ``<config>.<traffic>`` -> its files and its grid.

``configs/<config>.json`` holds the deployment: fabric, CC stacks, every
stage constant, the sweep horizon and trace interval.  ``traffic/<mix>.json``
holds the flow pattern, the engine tier and the parameter axis each sweep
of the window takes its point from.  Both are plain data; this module
turns them and a seed into the runs of one sweep.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os

import numpy as np

from ..reference import fabric as ref_fabric
from . import traffic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INF = float("inf")


def _load(kind: str, name: str) -> dict:
    with open(os.path.join(ROOT, kind, f"{name}.json")) as f:
        return json.load(f)


def _inf(v):
    return INF if v is None else float(v)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    seed: int
    fabrics: dict                 # roll -> reference Fabric
    scenes: dict                  # roll -> [scene]
    points: list                  # [(name, (m, n, r), roll, scene index)]
    axis_order: list              # the window's parameter points, in turn

    @property
    def tier(self) -> str:
        return self.mix["tier"]

    @property
    def steps(self) -> int:
        return int(self.mix.get("horizon_steps",
                                self.config["horizon_steps"]))

    @property
    def trace_every(self) -> int:
        return int(self.config["trace_every"])

    @property
    def dt(self) -> float:
        return float(self.config["params"]["sim"]["dt"])

    @property
    def runs(self) -> int:
        return len(self.points)

    def params(self, scale: float = 1.0) -> dict:
        """The configuration's constants with the mix's axis paths scaled
        (``dcqcn.kmin`` and the like)."""
        p = copy.deepcopy(self.config["params"])
        for path in self.mix["axis"]["paths"]:
            group, key = path.split(".")
            p[group][key] = p[group][key] * scale
        return p

    def scale(self, i: int) -> float:
        """The parameter point of the window's ``i``-th sweep."""
        return self.axis_order[i % len(self.axis_order)]


def stacks(config: dict) -> list:
    st = config["stacks"]
    if st == "all":
        return [(m, n, r) for m in config["marking"]
                for n in config["notification"] for r in config["reaction"]]
    return [tuple(s) for s in st]


def load(name: str, seed: int, overrides: dict | None = None) -> Cell:
    """The cell ``<config>.<traffic>`` for ``seed``; ``overrides`` replaces
    top-level keys of the config and the mix (tests shrink a cell so)."""
    cname, _, mname = name.partition(".")
    config, mix = _load("configs", cname), _load("traffic", mname)
    for key, val in (overrides or {}).get("config", {}).items():
        config[key] = val
    for key, val in (overrides or {}).get("traffic", {}).items():
        mix[key] = val
    fabrics, scns = {}, {}
    for roll in config.get("wirings", [0]):
        fabrics[roll] = ref_fabric.build(config["fabric"], roll)
        scns[roll] = traffic.scenes(mix, fabrics[roll], seed)
        for sc in scns[roll]:
            sc["t_start"] = [_inf(v) for v in sc["t_start"]]
            sc["t_stop"] = [_inf(v) for v in sc["t_stop"]]
            sc["volume"] = [_inf(v) for v in sc["volume"]]
    points = []
    for st in stacks(config):
        for roll in fabrics:
            for i, sc in enumerate(scns[roll]):
                points.append((f"{'+'.join(st)}/w{roll}/{sc['name']}", st,
                               roll, i))
    scales = list(mix["axis"]["scales"])
    order = np.random.default_rng([seed, 2]).permutation(len(scales))
    return Cell(name=name, config=config, mix=mix, seed=seed,
                fabrics=fabrics, scenes=scns, points=points,
                axis_order=[scales[k] for k in order])
