"""The port's soft model over whole trajectories, and the gradient's
reach, on the CPU.

  * annealing converges on the golden 18-point grid, in the order the
    reference's ``test_annealing_converges_on_golden_grid`` asserts:
    zero error at tau = 0, tau = 0.08 below tau = 0.5, each stage within
    10% of the one before;
  * the port's delivered bytes at tau = 0.2 are within rtol 2e-3 of the
    reference's on that grid (the golden suite's float tolerance);
  * every knob of ``dcqcn_box`` and ``rev_box`` gets a nonzero gradient:
    the box's values reach the reaction kernels through their parameter
    rows, packed inside the differentiated call (packed once outside it,
    ``rp_g`` / ``rp_rdf`` / ``rp_rai`` and the ``erp_*`` knobs would get
    exactly zero).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.core import CCScheme, PAPER_CONFIG, ScenarioSpec  # noqa
from repro_torch.tune.optimizers import Evaluator, TuneProblem  # noqa: E402
from test_torch_fluid import port_grid                       # noqa: E402

N_STEPS = 300
TAUS = (0.5, 0.2, 0.08, 0.0)
RTOL = 2e-3


def _delivered(res) -> np.ndarray:
    return np.asarray([res[n].final.delivered.sum()
                       for n in sorted(res.names)], np.float64)


@pytest.fixture(scope="module")
def port_runs():
    sweep = port_grid()
    ref = _delivered(sweep.run(n_steps=N_STEPS, device="cpu"))
    return ref, {tau: _delivered(sweep.run(n_steps=N_STEPS, temperature=tau,
                                           device="cpu"))
                 for tau in TAUS}


def test_annealing_converges_on_golden_grid(port_runs):
    ref, runs = port_runs
    errs = {tau: float(np.mean(np.abs(d - ref) / (np.abs(ref) + 1.0)))
            for tau, d in runs.items()}
    assert errs[0.0] == 0.0
    assert errs[0.08] < errs[0.5]
    assert errs[0.2] <= errs[0.5] * 1.10 + 1e-12
    assert errs[0.08] <= errs[0.2] * 1.10 + 1e-12


def test_soft_delivered_matches_reference(port_runs):
    from test_fluid_fused import _grid
    _, runs = port_runs
    res = _grid().run(n_steps=N_STEPS, temperature=0.2)
    want = np.asarray([np.asarray(res[n].final.delivered).sum()
                       for n in sorted(res.summary())], np.float64)
    np.testing.assert_allclose(runs[0.2], want, rtol=RTOL)


def _knob_problem(scheme):
    """2 senders at 0.55 of line rate each (a 10% overload): marks come
    and go, so every reaction branch runs within 600 steps; DCQCN's
    timer is shortened to 10 us so its additive-increase stage (where
    ``rai`` acts) is reached too."""
    cfg = PAPER_CONFIG.replace(scheme=scheme)
    if scheme is CCScheme.DCQCN:
        cfg = dataclasses.replace(
            cfg, dcqcn=dataclasses.replace(cfg.dcqcn, timer_T=1e-5))
    scn = ScenarioSpec.incast(2, t_start=1e-4, t_stop=1.1e-3,
                              gen_rate=0.55 * cfg.link.line_rate,
                              victim=False)
    return TuneProblem(cfg, scn, objective="goodput", n_steps=600,
                       trace_every=50, device="cpu")


@pytest.mark.parametrize("scheme", [CCScheme.DCQCN, CCScheme.DCQCN_REV],
                         ids=lambda s: s.name)
def test_every_box_knob_has_a_gradient(scheme):
    ev = Evaluator(_knob_problem(scheme))
    _, grad = ev.value_and_grad(ev.box.encode(ev.spec), 0.25)
    assert np.all(np.isfinite(grad))
    assert np.all(grad != 0.0), dict(zip(ev.box.names, grad))
