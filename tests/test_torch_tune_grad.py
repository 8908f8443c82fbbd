"""``Evaluator.value_and_grad`` of the port against the reference's
gradient, objective by objective, on the CPU.

The problem is the reference's FD-test scene cut to size: paper-default
DCQCN on ``incast(4, t_start=1e-4, t_stop=1.1e-3)``, 300 steps, a trace
sample every 50, tau = 0.25, at theta0 (the paper defaults) and one
seeded random theta.  The reference side is the loss its
``Evaluator._vag_exec`` differentiates (``box.apply``, ``fluid_step``
with ``reduce="fused", dense_rows=0``, ``decimating_scan``, the
objective), taken once through ``jax.jacrev`` for all four objectives
and the per-flow delivered bytes.

Tolerances: value rtol 2e-3, gradient cosine >= 0.99 and norm ratio in
[0.9, 1.1].  One measured exception, with its cause: the reference's
``jain`` gradient is wrong.  Its division VJP squares the denominator
``n * sum(x * x)`` (~1.3e20 here) in float32, which overflows to inf and
drops the quotient's second term; what is left is the same derivative
for every flow, while Jain's index is scale-invariant (its true
gradient is orthogonal to x).  So ``jain`` is held to the reference's per-flow Jacobian chained
with Jain's derivative in float64 — the same dynamics, without the
overflow — and the reference's own gradient is shown to be the
overflowed one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

import repro.core as R                                       # noqa: E402
from repro.core.fluid import fluid_step as fluid_step_R      # noqa: E402
from repro.core.simulator import decimating_scan as scan_R   # noqa: E402
from repro.tune import objectives as objR                    # noqa: E402
from repro.tune.optimizers import Evaluator as EvR           # noqa: E402
from repro.tune.optimizers import TuneProblem as TPR         # noqa: E402
from repro_torch.core import CCScheme, PAPER_CONFIG, ScenarioSpec  # noqa
from repro_torch.tune.optimizers import Evaluator, TuneProblem  # noqa: E402

TAU = 0.25
N_STEPS = 300
TRACE_EVERY = 50
FAST = dict(t_start=1e-4, t_stop=1.1e-3)
NAMES = ("goodput", "jain", "p99_slowdown", "ctrl_overhead")
VALUE_RTOL = 2e-3
MIN_COSINE = 0.99
NORM_RATIO = (0.9, 1.1)


def _thetas(box_d, theta0):
    g = np.random.default_rng(19)
    return [theta0, theta0 + 0.5 * g.standard_normal(box_d)]


@pytest.fixture(scope="module")
def reference():
    """[2 thetas] of (objective values [4], their gradients [4, d],
    delivered [F], its Jacobian [F, d]) from the reference's loss."""
    cfg = R.PAPER_CONFIG.replace(scheme=R.CCScheme.DCQCN)
    ev = EvR(TPR(cfg, R.ScenarioSpec.incast(4, **FAST), n_steps=N_STEPS,
                 trace_every=TRACE_EVERY))
    fns = [objR.resolve(n)[0] for n in NAMES]

    def loss(theta):
        par = ev.box.apply(ev.par0, theta)
        par = par._replace(temperature=jnp.asarray(TAU, jnp.float32))
        step = lambda s: fluid_step_R(                        # noqa: E731
            s, ev.sd, par, dt=ev.dt, n_switches=ev.n_sw, reduce="fused",
            dense_rows=0)
        final, tr = scan_R(step, ev.st0, ev.n_samples, ev.k, ev.dt)
        objs = jnp.stack([f(final, tr, ev.ctx) for f in fns])
        return jnp.concatenate([objs, final.delivered])

    f = jax.jit(jax.vmap(lambda th: (loss(th), jax.jacrev(loss)(th))))
    thetas = _thetas(ev.box.d, ev.box.encode(ev.spec))
    vals, jac = f(jnp.asarray(np.stack(thetas), jnp.float32))
    vals, jac = np.asarray(vals, np.float64), np.asarray(jac, np.float64)
    n = len(NAMES)
    return [dict(theta=th, values=v[:n], grads=j[:n], delivered=v[n:],
                 jac=j[n:]) for th, v, j in zip(thetas, vals, jac)]


def _jain_grad64(delivered, jac):
    """Jain's index of the per-flow rates (one span for every flow here)
    differentiated in float64 through the per-flow Jacobian."""
    x = delivered
    s, q, n = x.sum(), (x * x).sum(), x.size
    dj = 2 * s / (n * q) - 2 * s * s * x / (n * q * q)
    return dj @ jac


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("name", NAMES)
def test_value_and_grad_matches_reference(reference, name, which):
    ref = reference[which]
    i = NAMES.index(name)
    cfg = PAPER_CONFIG.replace(scheme=CCScheme.DCQCN)
    ev = Evaluator(TuneProblem(cfg, ScenarioSpec.incast(4, **FAST),
                               objective=name, n_steps=N_STEPS,
                               trace_every=TRACE_EVERY, device="cpu"))
    assert np.array_equal(ev.box.encode(ev.spec), reference[0]["theta"])
    val, grad = ev.value_and_grad(ref["theta"], TAU)
    want = ref["grads"][i]
    if name == "jain":
        # the reference's own gradient is the overflowed one: the first
        # term of the quotient rule alone, the same for every flow, so
        # its Jacobian-chained float64 version is held instead
        x = ref["delivered"]
        first = 2 * x.sum() / (x.size * (x * x).sum()) * ref["jac"].sum(0)
        np.testing.assert_allclose(want, first, rtol=1e-2)
        want = _jain_grad64(x, ref["jac"])
    np.testing.assert_allclose(val, ref["values"][i], rtol=VALUE_RTOL)
    assert np.all(np.isfinite(grad))
    ng, nw = np.linalg.norm(grad), np.linalg.norm(want)
    assert nw > 0, (name, want)
    cos = float(grad @ want / (ng * nw))
    assert cos >= MIN_COSINE, (name, which, cos, grad, want)
    assert NORM_RATIO[0] <= ng / nw <= NORM_RATIO[1], (name, which, ng / nw)
