"""Every cell of BENCHMARK.json resolves by name to files of its own, and
the file keeps to the benchmark's contract."""

import json
import os
import re

import numpy as np
import pytest

from conftest import ROOT

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "ccbench/run.py"]
    assert BENCH["paths"] == ["ccbench"]
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_resolve_by_name(cell):
    from ccbench.harness import cell as cell_mod
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert cell == f"{entry['config']}.{entry['traffic']}"
    assert entry["chips"] == 1
    cfg = next(c for c in BENCH["configs"] if c["name"] == entry["config"])
    assert cfg["file"] == f"ccbench/configs/{entry['config']}.json"
    assert os.path.isfile(os.path.join(ROOT, cfg["file"]))
    assert os.path.isfile(os.path.join(
        ROOT, "ccbench", "traffic", f"{entry['traffic']}.json"))
    c = cell_mod.load(cell, 2 ** 31 + 5)
    assert c.runs == len(c.points) > 0 and c.steps > 0


def test_names_units_and_bounds():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
        assert os.path.isfile(os.path.join(ROOT, "ccbench", "metrics",
                                           f"{m['name']}.py"))
        for cell in m["workloads"]:     # the moved metric is reported there
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
        if m["unit"] == "%" and m["name"].endswith("_roofline"):
            assert m["better"] == "higher"


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_setup_another_and_a_layer(cell):
    e2e = [m["name"] for m in BENCH["end_to_end"]
           if cell in m.get("workloads", CELLS)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell in m["workloads"] for m in BENCH["per_layer"])


def test_run_seconds_fits_the_full_check():
    n = 24
    runs = 2 + 14 * n
    total = runs * (BENCH["run_seconds"] + 60) + n * 2 * 90 + 1200
    assert 1 <= BENCH["run_seconds"] <= 51 and total <= 43200


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11])
def test_the_seed_renames_hosts_but_keeps_the_work(seed):
    """Every link carries as many flows, over as many hops, whatever the
    seed: the seed picks which hosts behind a router talk."""
    from ccbench.harness import cell as cell_mod
    from ccbench.reference import scenario

    def load(s):
        c = cell_mod.load("dfly1056_stages36.permutation", s)
        scn = scenario.build(c.fabrics[0], c.scenes[0][0],
                             c.config["params"]["link"], c.dt)
        per_link = np.bincount(scn["routes"][scn["routes"] >= 0],
                               minlength=c.fabrics[0].n_links)
        return scn, per_link

    a, la = load(1)
    b, lb = load(seed)
    assert sorted(la) == sorted(lb)
    assert la.max() == lb.max()
    assert (np.sort(a["hops"]) == np.sort(b["hops"])).all()
    assert (a["hops"] == b["hops"]).all()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]
                                  if json.load(open(os.path.join(
                                      ROOT, "ccbench", "traffic",
                                      f"{w['traffic']}.json")))["tier"]
                                  == "mega"])
def test_mega_cells_fit_the_megakernel(cell):
    """A mega-tier cell's fabric fits the megakernel's shared memory, which
    the program checks only on the card (dragonfly(8,4,4)'s 5016 links do
    not)."""
    from ccbench.harness import cell as cell_mod
    from repro_torch.kernels import fluid_step
    c = cell_mod.load(cell, 2 ** 31 + 5)
    V = c.config["params"]["link"]["n_vcs"]
    for fab in c.fabrics.values():
        smem = fluid_step.mega_footprint(fab.n_links * V, fab.n_links,
                                         fab.n_switches, V)
        assert smem <= fluid_step.MEGA_SMEM_CAP, (cell, smem)


def test_the_1k_dragonfly_does_not_fit_the_megakernel():
    """Why the mega cells run Kim et al.'s 72-host dragonfly: the program
    refuses the 1056-host one on the mega tier."""
    from ccbench.reference import fabric
    from repro_torch.kernels import fluid_step
    fab = fabric.build({"kind": "dragonfly", "a": 8, "p": 4, "h": 4,
                        "groups": 33}, 0)
    assert fluid_step.mega_footprint(fab.n_links, fab.n_links,
                                     fab.n_switches, 1) \
        > fluid_step.MEGA_SMEM_CAP
