"""The port's Sweep (``repro_torch.core.experiments``) against the
reference's frozen golden grids, on the CPU.

  * ``tests/golden/routing_sweep.json``: 18 points (3 schemes x 2
    fabrics x min/valiant/ugal), 600 steps;
  * ``tests/golden/pfc_pathology.json``: 9 points (3 schemes x HoL-victim
    incast / pause storm / credit loop), 5000 steps, and the paper's
    victim ordering REV < DCQCN < PFC-only.

Tolerances are the golden suite's own (``tests/test_golden.py``): floats
rtol 2e-3, counters within 2% or +-2 events.  Reason: the trajectories
are not bit-for-bit the reference's (XLA fuses multiply-adds the port
rounds twice, see ``test_torch_fluid``), and a 1-ulp difference can move
a threshold crossing by a step.

Also here: the options the port does not have yet raise
NotImplementedError (a positive temperature on a kernel tier raises
ValueError, as in the reference), the whole-step tier and ``reduce="pallas"`` run,
and the entry points refuse to run without a device when no GPU is
present.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)      # tiny tensors: threads only add overhead

from repro_torch.core import (CCSpec, PAPER_CONFIG, ScenarioSpec,  # noqa: E402
                              Sweep)
from repro_torch.core import simulator                      # noqa: E402
from repro_torch.core.workloads import (credit_loop,        # noqa: E402
                                        hol_victim_incast, pause_storm)
from repro_torch.net import FabricSpec                      # noqa: E402
from test_torch_fluid import port_grid                      # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
FLOAT_KEYS = ("aggregate_gbps", "completion_ms", "delivered_mb",
              "peak_queue_kb")
COUNT_KEYS = ("marks", "cnps", "peak_nonmin_flows")
PATHOLOGY_FLOAT_KEYS = ("aggregate_gbps", "delivered_mb", "peak_queue_kb",
                        "victim_slowdown", "pause_s")
PATHOLOGY_COUNT_KEYS = ("marks", "cnps")
SCHEMES = {
    "PFC_ONLY": CCSpec(marking="cp", notification="np", reaction="pfc"),
    "DCQCN": CCSpec(marking="cp", notification="np", reaction="rp"),
    "DCQCN_REV": CCSpec(marking="ecp", notification="enp", reaction="erp"),
}


def _golden(name):
    with open(os.path.join(GOLDEN, name)) as f:
        return json.load(f)


def _check(got: dict, want: dict, fkeys, ckeys):
    assert set(got) == set(want)
    for name, row in got.items():
        for k in fkeys:
            g, w = row[k], want[name][k]
            if np.isnan(w):
                assert np.isnan(g), (name, k, g)
                continue
            np.testing.assert_allclose(g, w, rtol=2e-3, atol=1e-9,
                                       err_msg=f"{name}.{k}")
        for k in ckeys:
            g, w = row[k], want[name][k]
            assert abs(g - w) <= max(2, 0.02 * w), (name, k, g, w)


def test_routing_golden_on_cpu():
    doc = _golden("routing_sweep.json")
    res = port_grid().run(n_steps=doc["n_steps"], device="cpu")
    _check(res.summary(), doc["summaries"], FLOAT_KEYS, COUNT_KEYS)


def test_pathology_golden_and_victim_ordering_on_cpu():
    doc = _golden("pfc_pathology.json")
    clos = FabricSpec.clos3(4)
    dfly = FabricSpec.dragonfly(a=2, p=2, h=2)
    sweep = Sweep.grid(configs=SCHEMES, scenarios={
        "holvictim": hol_victim_incast(4, 64).spec(fabric=clos),
        "pausestorm": pause_storm(3, 4, 64).spec(fabric=clos),
        "creditloop": credit_loop(5, 4).spec(fabric=dfly)})
    summ = sweep.run(n_steps=doc["n_steps"], device="cpu").summary()
    _check(summ, doc["summaries"], PATHOLOGY_FLOAT_KEYS,
           PATHOLOGY_COUNT_KEYS)
    vic = {s: summ[f"{s}/holvictim"]["victim_slowdown"] for s in SCHEMES}
    assert vic["DCQCN_REV"] < vic["DCQCN"] < vic["PFC_ONLY"], vic
    storm = {s: summ[f"{s}/pausestorm"]["pause_s"] for s in SCHEMES}
    assert storm["PFC_ONLY"] > 10 * max(storm["DCQCN"],
                                        storm["DCQCN_REV"], 1e-9), storm


def test_simulator_run_matches_sweep_point():
    """The single-point entry is a Sweep of one: same traces and state."""
    cfg = PAPER_CONFIG
    spec = ScenarioSpec.paper_incast(roll=0, t_start=0.02e-3)
    one = simulator.run(spec.build(cfg), cfg, n_steps=200, trace_every=10,
                        device="cpu")
    pt = Sweep([("p", cfg, spec)]).run(n_steps=200, trace_every=10,
                                       device="cpu")["p"]
    for f in ("delivered", "rate", "inst_thr", "max_q", "n_paused",
              "marked", "cnp", "n_nonmin", "ctrl", "pause_time",
              "vc_stall"):
        assert np.array_equal(getattr(one, f), getattr(pt, f)), f
    assert np.array_equal(one.final.delivered, pt.final.delivered)
    s = one.summary()
    assert s["marks"] > 0 and s["delivered_mb"] > 0
    assert np.isfinite(one.ctrl_per_mb()) and np.isfinite(one.p99_slowdown())


def test_pad_runs_to_and_delay_slots_leave_results_unchanged():
    sweep = Sweep.grid(configs=SCHEMES,
                       scenarios=ScenarioSpec.paper_incast(
                           roll=0, t_start=0.02e-3))
    a = sweep.run(n_steps=100, device="cpu")
    b = sweep.run(n_steps=100, device="cpu", pad_runs_to=5,
                  min_delay_slots=16, min_switches=90)
    for f in a.traces._fields:
        assert np.array_equal(getattr(a.traces, f), getattr(b.traces, f)), f


@pytest.mark.parametrize("kw, exc, slice_", [
    (dict(temperature=0.1, use_kernels=True), ValueError,
     "hard dynamics only"),
    (dict(mesh=object()), TypeError, "mesh"),
])
def test_unported_options_raise(kw, exc, slice_):
    """``mesh=`` takes a torch ``DeviceMesh`` (``tests/
    test_torch_sharded_sweep.py`` runs it) and refuses anything else; a
    positive temperature runs (the soft model, ``tests/test_torch_tune.py``)
    but not on a kernel tier, which computes the hard dynamics only, as
    in the reference."""
    sweep = Sweep.grid(configs=SCHEMES,
                       scenarios=ScenarioSpec.paper_incast(roll=0))
    with pytest.raises(exc, match=slice_):
        sweep.run(n_steps=10, device="cpu", **kw)


@pytest.mark.parametrize("kw", [dict(use_kernels="mega"),
                                dict(reduce="pallas")])
def test_ported_options_run_on_cpu(kw):
    """The whole-step tier and the segment_reduce engine run (their
    plain versions on the CPU) and agree with the default path."""
    sweep = Sweep.grid(configs=SCHEMES,
                       scenarios=ScenarioSpec.paper_incast(
                           roll=0, t_start=0.02e-3))
    a = sweep.run(n_steps=60, trace_every=10, device="cpu")
    b = sweep.run(n_steps=60, trace_every=10, device="cpu", **kw)
    for f in a.traces._fields:
        assert np.array_equal(getattr(a.traces, f), getattr(b.traces, f)), f


def test_sweep_without_device_raises_without_gpu(monkeypatch):
    """No silent CPU fallback: device=None means the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sweep = Sweep.grid(configs=SCHEMES,
                       scenarios=ScenarioSpec.paper_incast(roll=0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep.run(n_steps=10)
    scn = ScenarioSpec.paper_incast(roll=0).build(PAPER_CONFIG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulator.run(scn, PAPER_CONFIG, n_steps=10)
