"""The port's tuner loops and front door (``repro_torch.tune``) on the
CPU, after the reference's ``tests/test_tune.py``.

  * a killed-and-resumed GradTuner and ESTuner replay the uninterrupted
    trajectory bit for bit (``repro_torch.ckpt``; host float64 state,
    per-iteration ``default_rng([seed, it])``);
  * BOTuner runs; ``autotune`` by ES returns a hard-verified record that
    serialises to JSON; an unknown method raises;
  * ``pareto_front`` keeps the non-dominated rows, as the reference's;
    ``pareto_autotune`` pools hard-scored candidates into a front.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.tune.pareto import pareto_front as pareto_front_R  # noqa: E402
from repro_torch.core import CCScheme, PAPER_CONFIG, ScenarioSpec  # noqa
from repro_torch.tune import (BOTuner, ESTuner, Evaluator,   # noqa: E402
                              GradTuner, TuneProblem, autotune,
                              dcqcn_box, pareto_autotune, pareto_front)

FAST = dict(t_start=1e-4, t_stop=1.1e-3)
DCQCN = PAPER_CONFIG.replace(scheme=CCScheme.DCQCN)


def _problem(n_steps: int, t_start: float = FAST["t_start"]) -> TuneProblem:
    scn = ScenarioSpec.incast(3, t_start=t_start, t_stop=FAST["t_stop"])
    return TuneProblem(DCQCN, scn, n_steps=n_steps, trace_every=50,
                       device="cpu")


def test_grad_tuner_resume_bit_exact(tmp_path):
    ev = Evaluator(_problem(100, t_start=0.0))
    kw = dict(lr=0.2, temperature=0.3)
    full = GradTuner(iters=4, **kw).run(ev, seed=0)
    d = str(tmp_path / "grad")
    GradTuner(iters=2, **kw).run(ev, seed=0, ckpt_dir=d, ckpt_every=2)
    resumed = GradTuner(iters=4, **kw).run(ev, seed=0, ckpt_dir=d)
    assert np.array_equal(full.theta, resumed.theta)
    assert np.array_equal(full.value, resumed.value)
    assert len(full.value) == 5 and not np.array_equal(full.theta[0],
                                                        full.theta[-1])


def test_es_tuner_resume_bit_exact(tmp_path):
    ev = Evaluator(_problem(200))
    tuner = dict(iters=3, pop=4, sigma=0.3, lr=0.4)
    full = ESTuner(**tuner).run(ev, seed=1)
    d = str(tmp_path / "es")
    ESTuner(**dict(tuner, iters=2)).run(ev, seed=1, ckpt_dir=d,
                                        ckpt_every=2)
    resumed = ESTuner(**tuner).run(ev, seed=1, ckpt_dir=d)
    assert np.array_equal(full.theta, resumed.theta)
    assert np.array_equal(full.value, resumed.value)
    with pytest.raises(ValueError, match="even"):
        ESTuner(pop=3).run(ev)


def test_bo_tuner_smoke():
    ev = Evaluator(_problem(300))
    trace = BOTuner(iters=2, init=3, q=1, cand=32).run(ev, seed=0)
    assert trace.theta.shape[1] == ev.box.d
    assert len(trace.value) >= 5
    assert np.all(np.isfinite(trace.value))
    assert trace.best.shape == (ev.box.d,)


def test_autotune_es_smoke_and_record():
    res = autotune(DCQCN, ScenarioSpec.incast(3, **FAST), method="es",
                   n_steps=300, trace_every=50, iters=2, pop=4, seed=0,
                   max_candidates=4, device="cpu")
    assert res.method == "es"
    assert res.best_value >= res.baseline_value
    assert len(res.candidate_values) == len(res.candidates)
    assert set(res.best_params) == set(dcqcn_box().names)
    rec = res.to_record()
    assert rec["best_value"] == res.best_value
    assert rec["best_cfg"]["__class__"] == "CCSpec"
    json.dumps(rec)
    for m in (res.baseline_metrics, res.best_metrics):
        assert {"goodput", "jain", "p99_slowdown", "ctrl_overhead",
                "aggregate_gbps"} <= set(m)
        assert m["p99_slowdown"] >= 1.0


def test_autotune_unknown_method():
    with pytest.raises(KeyError, match="unknown method"):
        autotune(DCQCN, ScenarioSpec.incast(3), method="nope",
                 device="cpu")


def test_pareto_front_matches_reference():
    vals = np.asarray([[1.0, 1.0], [2.0, 0.5], [0.5, 2.0],
                       [0.9, 0.9], [2.0, 0.5]])
    keep = pareto_front(vals)
    assert keep.tolist() == pareto_front_R(vals).tolist() == [0, 1, 2, 4]
    g = np.random.default_rng(2)
    for _ in range(5):
        v = g.standard_normal((20, 3))
        senses = g.choice([-1.0, 1.0], 3)
        assert np.array_equal(pareto_front(v, senses),
                              pareto_front_R(v, senses))
    with pytest.raises(ValueError):
        pareto_front(np.zeros(3))


def test_pareto_autotune_smoke():
    out = pareto_autotune(DCQCN, ScenarioSpec.incast(3, t_start=0.0,
                                                     t_stop=FAST["t_stop"]),
                          n_weights=2, method="es", n_steps=100,
                          trace_every=50, iters=1, pop=2, max_candidates=2,
                          device="cpu")
    assert out["axes"] == ["goodput", "p99_slowdown"]
    assert len(out["results"]) == 2 and out["front"]
    for point in out["front"]:
        assert set(point["params"]) == set(dcqcn_box().names)
        assert len(point["axis_values"]) == 2
    with pytest.raises(ValueError, match=">= 2"):
        pareto_autotune(DCQCN, ScenarioSpec.incast(3), axes=("goodput",),
                        device="cpu")
