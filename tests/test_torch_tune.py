"""The port's soft model (``repro_torch.tune.soft`` and the soft sites of
``core.fluid`` / ``core.cc``), the kernels' autograd rules and the search
box, against the reference (``repro.tune``) on the CPU.

  * the soft primitives agree with the reference's within a few ulps;
  * ``Sweep.run(temperature=0.0)`` is the default run bit for bit (the
    same cache entry), ``temperature > 0`` changes the dynamics, and the
    kernel tiers refuse it;
  * one soft step from identical state at tau = 0.3 agrees with the
    reference's ``fluid_step`` on the golden grid (continuous fields
    within a stated bound, discrete ones exactly);
  * each autograd rule passes ``torch.autograd.gradcheck`` at float64
    against finite differences of its plain version;
  * ``ParamBox`` encodes and writes back exactly what the reference's
    does; the hard objective and the summary carry the tuner metrics.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax                                                   # noqa: E402
import jax.numpy as jnp                                      # noqa: E402

from repro.core import fluid as fluidR                       # noqa: E402
from repro.tune import optimizers as OR                      # noqa: E402
from repro.tune import soft as softR                         # noqa: E402
from repro_torch import convert                              # noqa: E402
from repro_torch.core import (CCScheme, PAPER_CONFIG,        # noqa: E402
                              SWEEP_EXEC_CACHE, ScenarioSpec, Sweep, cc)
from repro_torch.core import fluid as fluidP                 # noqa: E402
from repro_torch.core.serialize import config_to_dict        # noqa: E402
from repro_torch.kernels import cc_step as K                 # noqa: E402
from repro_torch.kernels import fluid_reduce as FR           # noqa: E402
from repro_torch.kernels.ref import RPState                  # noqa: E402
from repro_torch.tune import objectives                      # noqa: E402
from repro_torch.tune import soft as softP                   # noqa: E402
from repro_torch.tune.optimizers import (Evaluator, ParamBox,  # noqa: E402
                                         TunableParam, TuneProblem,
                                         box_for, dcqcn_box, rev_box)

FAST = dict(t_start=1e-4, t_stop=1.1e-3)
N_STEPS = 900
EPS32 = float(np.finfo(np.float32).eps)
#: soft primitives: ulps of the operands' magnitude (sigmoid, exp and
#: log1p differ in their last bits between XLA and torch)
SOFT_ULPS = 4.0
#: one soft step from identical state: ulps of each field's scale.  The
#: sigmoid gates put XLA's and torch's transcendental rounding (a few
#: ulps) on every softened site, and the hard plumbing's 1-ulp
#: multiply-add differences (ROADMAP parity contract) ride along; the
#: worst seen over the 40 steps here is 2.58 ulps.
SOFT_STEP_ULPS = 8.0
SOFT_STEPS = 40
DCQCN = PAPER_CONFIG.replace(scheme=CCScheme.DCQCN)


def _small_sweep() -> Sweep:
    return Sweep.grid(
        configs={s.name: PAPER_CONFIG.replace(scheme=s)
                 for s in (CCScheme.DCQCN, CCScheme.DCQCN_REV)},
        scenarios={"in4": ScenarioSpec.incast(4, **FAST)})


def _delivered(res) -> np.ndarray:
    return np.asarray([res[n].final.delivered.sum() for n in res.names])


# ---------------------------------------------------------------------------
# soft primitives
# ---------------------------------------------------------------------------


def _operands(n=4096, seed=0):
    g = np.random.default_rng(seed)
    f = lambda x: np.asarray(x, np.float32)                 # noqa: E731
    return dict(x=f(g.standard_normal(n) * 3),
                tau=f(np.where(g.random(n) < 0.25, 0.0, g.random(n) * 0.5)),
                scale=f(g.random(n) * 2 + 0.1), a=f(g.standard_normal(n)),
                b=f(g.standard_normal(n)), lo=f(-g.random(n)),
                hi=f(g.random(n) + 0.1), gate=f(g.random(n)))


@pytest.mark.parametrize("name", ["safe_tau", "unit_gate", "select", "pick",
                                  "softplus", "clip"])
def test_soft_primitives_match_reference(name):
    o = _operands()
    cond = o["gate"] > 0.5
    args = {"safe_tau": ("tau",), "unit_gate": ("x", "tau", "scale"),
            "select": ("tau", "a", "b"), "pick": ("tau", "gate", cond,
                                                  "a", "b"),
            "softplus": ("x", "scale"),
            "clip": ("x", "lo", "hi", "tau", "scale")}[name]
    vals = [o[a] if isinstance(a, str) else a for a in args]
    got = getattr(softP, name)(*[torch.from_numpy(np.asarray(v))
                                 for v in vals]).numpy()
    want = np.asarray(getattr(softR, name)(*[jnp.asarray(v) for v in vals]))
    mag = np.maximum.reduce([np.abs(want)] + [
        np.abs(v) for v in vals if np.asarray(v).dtype == np.float32])
    err = np.abs(got.astype(np.float64) - want) / (EPS32 * np.maximum(
        mag, np.finfo(np.float32).tiny))
    assert float(err.max()) <= SOFT_ULPS, (name, float(err.max()))
    if name in ("select", "pick", "clip"):
        hard = o["tau"] == 0          # tau = 0 takes the hard value, exactly
        assert np.array_equal(got[hard], want[hard])


def test_safe_tau_keeps_the_dead_branch_finite():
    """At tau = 0 the soft branch is dead, but its gradient must not be
    nan: select's zero times a finite vjp (the safe_tau trick)."""
    x = torch.tensor([-2.0, 0.0, 3.0], requires_grad=True)
    tau = torch.zeros(3)
    y = softP.select(tau, softP.unit_gate(x, tau, 1.0), (x > 0).float())
    (g,) = torch.autograd.grad(y.sum(), x)
    assert torch.equal(g, torch.zeros(3))
    y = softP.clip(x, torch.tensor(-1.0), torch.tensor(1.0), tau, 1.0)
    (g,) = torch.autograd.grad(y.sum(), x)
    assert torch.isfinite(g).all()


# ---------------------------------------------------------------------------
# the soft model in the Sweep
# ---------------------------------------------------------------------------


def test_temperature_zero_is_bitwise_hard_and_the_same_entry():
    sweep = _small_sweep()
    hard = sweep.run(n_steps=N_STEPS, device="cpu")
    s0 = SWEEP_EXEC_CACHE.stats()
    tau0 = sweep.run(n_steps=N_STEPS, temperature=0.0, device="cpu")
    d = SWEEP_EXEC_CACHE.stats() - s0
    assert (d.misses, d.hits) == (0, 1), d
    for f in hard.traces._fields:
        assert np.array_equal(getattr(hard.traces, f),
                              getattr(tau0.traces, f)), f
    for f in ("delivered", "rate", "paused", "trig_buf", "tgt_buf"):
        assert np.array_equal(getattr(hard.final, f),
                              getattr(tau0.final, f)), f
    soft = sweep.run(n_steps=N_STEPS, temperature=0.3, device="cpu")
    assert not np.allclose(_delivered(hard), _delivered(soft), rtol=1e-6)


@pytest.mark.parametrize("tier", [True, "mega"])
def test_kernel_tiers_refuse_a_positive_temperature(tier):
    scn = ScenarioSpec.incast(3).build(DCQCN)
    with pytest.raises(ValueError, match="hard dynamics only"):
        _small_sweep().run(n_steps=64, temperature=0.1, use_kernels=tier,
                           device="cpu")
    with pytest.raises(ValueError, match="hard dynamics only"):
        fluidP.make_step_fn(scn, DCQCN, use_kernels=tier, temperature=0.1,
                            device="cpu")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ulps(a, b) -> float:
    scale = max(float(np.abs(a).max(initial=0.0)), 1e-30)
    return float(np.abs(a.astype(np.float64) - b).max(initial=0.0)
                 / (EPS32 * scale))


def test_soft_step_matches_reference_on_golden_grid():
    """From identical state, one soft step at tau = 0.3 of every run of
    the golden grid: float fields within SOFT_STEP_ULPS of the field's
    scale, integer fields and the trace's booleans exactly."""
    from test_fluid_fused import _grid
    tau = 0.3
    sweep = _grid()
    static, (st, sd, par), _, _ = sweep._prepare(
        SOFT_STEPS, reduce="fused", temperature=tau)
    _, _, dt, n_sw, _, dense_rows, _, _, n_vcs, _, _ = static
    ref_step = jax.jit(jax.vmap(lambda s, d, p: fluidR.fluid_step(
        s, d, p, dt=dt, n_switches=n_sw, reduce="fused",
        dense_rows=dense_rows, n_vcs=n_vcs)))
    sd_p = convert.scenario_dev_from_numpy(_np(sd), device="cpu")
    par_p = convert.step_params_from_numpy(_np(par), device="cpu")
    assert torch.equal(par_p.temperature, torch.full_like(
        par_p.temperature, tau))
    plan = fluidP.reduce_plan(sd_p, n_switches=n_sw, n_vcs=n_vcs,
                              dense_rows=dense_rows, dt=dt)
    packed = cc.pack_react_rows(par_p.react, par_p.line_rate, plan.dt)
    worst = 0.0
    for t in range(SOFT_STEPS):
        nxt, tr = ref_step(st, sd, par)
        want = _np(nxt)
        got, gtr = fluidP._step_body(
            convert.state_from_numpy(_np(st), device="cpu"), sd_p, par_p,
            plan, n_switches=n_sw, reduce="fused", n_vcs=n_vcs,
            packed_react=packed, tau=par_p.temperature)
        got = convert.state_to_numpy(got)
        for f in fluidR.FluidState._fields:
            a, b = getattr(want, f), getattr(got, f)
            for k, x in (a.items() if isinstance(a, dict) else [(f, a)]):
                y = b[k] if isinstance(b, dict) else b
                if x.dtype.kind == "f":
                    worst = max(worst, _ulps(x, y))
                    assert _ulps(x, y) <= SOFT_STEP_ULPS, (t, k, _ulps(x, y))
                else:
                    assert np.array_equal(x, y), (t, k)
        for f in ("marked", "cnp", "n_nonmin", "n_paused"):
            assert np.array_equal(np.asarray(getattr(tr, f)),
                                  getattr(gtr, f).numpy()), (t, f)
        for f in ("delivered", "rate", "ctrl", "pause_time"):
            x = np.asarray(getattr(tr, f))
            assert _ulps(x, getattr(gtr, f).numpy()) <= SOFT_STEP_ULPS, (t, f)
        st = nxt
    assert worst > 0.0      # the two sides are compared, not one reused


# ---------------------------------------------------------------------------
# autograd rules
# ---------------------------------------------------------------------------


def _f64(g, shape, lo, hi):
    return (torch.rand(shape, generator=g, dtype=torch.float64)
            * (hi - lo) + lo).requires_grad_()


def _rule_cases():
    g = torch.Generator().manual_seed(3)
    R, F = 2, 5
    u = lambda lo, hi: _f64(g, (R, F), lo, hi)              # noqa: E731
    bern = (torch.rand((R, F), generator=g) < 0.5).double()
    rows = lambda *vals: torch.tensor(                        # noqa: E731
        [vals, [v * 1.1 for v in vals]], dtype=torch.float64,
        requires_grad=True)
    gen_rows = torch.tensor([[1.2e-5, 1e-6], [1.5e-5, 1e-6]],
                            dtype=torch.float64)
    yield ("gen_np_step", K.gen_np_plain,
           [u(0, 1e3), u(0, 1e4), u(0, 1), u(0, 1e-4), u(0, 1e9),
            u(0, 1e-5), u(5e-5, 6e-5), u(1e3, 2e4), u(100, 1e3)],
           lambda *a: (*a, gen_rows))
    # rates in units of 1e9 B/s (O(1) values, so float64 finite
    # differences resolve); every input away from its thresholds
    yield ("rp_step", lambda *a: K._rp_flat(*a),
           [u(1, 10), u(1, 10), u(0.1, 0.9), u(0, 5), u(0, 4e-5),
            u(0, 4e-5)],
           lambda *a: (*a, torch.floor(u(0, 9)).detach(),
                       torch.floor(u(0, 9)).detach(), bern,
                       rows(1 / 256, 0.5, 55e-6, 10.0, 5e-3, 2.5e-2, 5.0,
                            1e-3, 12.5, 1e-6)))
    yield ("erp_step", K.erp_plain,
           [u(1, 10), u(1e-5, 5e-5), u(1, 10), u(1e3, 5e3)],
           lambda r, h, t, s: (r, h, bern, t, s,
                               rows(0.95, 5e-5, 1e-3, 12.5, 1e-6)))
    # swift in microseconds too: qdelay's relative steps stay small
    yield ("swift_step", K.swift_plain,
           [u(1, 10), (u(10, 50) * bern).detach().requires_grad_(),
            (torch.where(bern > 0, u(0, 3), u(7, 10))
             .detach().requires_grad_())],
           lambda *a: (*a, rows(5.0, 0.5, 1e-2, 20.0, 1e-3, 12.5, 1.0)))


@pytest.mark.parametrize("case", list(_rule_cases()), ids=lambda c: c[0])
def test_cc_rules_gradcheck(case):
    """``PlainVJP`` (each CC kernel's autograd rule) at float64 against
    finite differences, the parameter rows among the inputs."""
    name, plain, leaves, full = case
    ins = list(full(*leaves))
    wrt = [x for x in ins if x.requires_grad]

    def fn(*xs):
        it = iter(xs)
        args = [next(it) if x.requires_grad else x for x in ins]
        return K.PlainVJP.apply(plain, plain, *args)

    assert torch.autograd.gradcheck(fn, wrt, eps=1e-6, atol=1e-5,
                                    rtol=1e-4), name


def test_segment_reduce_rule_gradcheck_and_refuses_repeats():
    g = torch.Generator().manual_seed(5)
    data = torch.randn((12, 3), generator=g, dtype=torch.float64,
                       requires_grad=True)
    off = torch.tensor([0, 3, 3, 7, 8], dtype=torch.int64)
    rows = torch.tensor([9, 0, 4, 2, 5, 1, 8, 11], dtype=torch.int64)

    def fn(d):
        return FR.SegmentSumVJP.apply(
            lambda x: FR.segment_reduce_plain(x, off, rows), d, off, rows)

    assert torch.autograd.gradcheck(fn, (data,))
    # the wrapper takes the rule whenever data requires a gradient
    d32 = data.detach().float().requires_grad_()
    out = FR.segment_reduce(d32, None, 4, rows=rows, offsets=off)
    (gw,) = torch.autograd.grad(out, d32, torch.ones_like(out))
    assert torch.equal(gw.sum(1) > 0, torch.isin(torch.arange(12), rows))
    dup = torch.tensor([9, 0, 4, 2, 5, 1, 8, 9], dtype=torch.int64)
    out = FR.segment_reduce(d32, None, 4, rows=dup, offsets=off)
    with pytest.raises(ValueError, match="at most once"):
        torch.autograd.grad(out, d32, torch.ones_like(out))


def test_rules_route_only_when_a_gradient_is_asked():
    """Without a gradient the wrappers build exactly the hard path (no
    autograd node); with one, the kernel's rule."""
    x = torch.rand(4, 6)
    st = RPState(*[x.clone() for _ in range(8)])
    rows = K.pack_rp_params(cc._rp_params(
        cc.REACTION.device_params(DCQCN.to_spec()), torch.tensor(12.5e9),
        torch.tensor(1e-6)))
    out = K.rp_step(st, x > 0.5, packed=rows)
    assert out.rate.grad_fn is None
    rows = rows.clone().requires_grad_()
    out = K.rp_step(st, x > 0.5, packed=rows)
    assert type(out.rate.grad_fn).__name__ == "PlainVJPBackward"


# ---------------------------------------------------------------------------
# the search box and the objectives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("box_name", ["dcqcn_box", "rev_box"])
def test_param_box_matches_reference(box_name):
    import repro.core as R
    box, rbox = {"dcqcn_box": (dcqcn_box(), OR.dcqcn_box()),
                 "rev_box": (rev_box(), OR.rev_box())}[box_name]
    cfg = DCQCN if box_name == "dcqcn_box" else PAPER_CONFIG
    rcfg = R.PAPER_CONFIG.replace(scheme=R.CCScheme[cfg.scheme.name])
    assert box.signature() == rbox.signature()
    th0 = box.encode(cfg)
    assert np.array_equal(th0, rbox.encode(rcfg))
    g = np.random.default_rng(11)
    for theta in [th0] + list(g.standard_normal((4, box.d)) * 2):
        t32 = np.asarray(theta, np.float32)
        assert np.array_equal(box.values(t32, xp=np),
                              rbox.values(t32, xp=np))
        np.testing.assert_allclose(
            box.values(torch.from_numpy(t32)).numpy(),
            np.asarray(rbox.values(jnp.asarray(t32))), rtol=1e-6)
        from repro.core.serialize import config_to_dict as ref_dict
        assert config_to_dict(box.to_spec(cfg, theta)) == \
            ref_dict(rbox.to_spec(rcfg, theta))


def test_param_box_apply_and_consistency():
    box = dcqcn_box()
    par = fluidP.step_params(DCQCN, device="cpu")
    theta = torch.tensor([0.7, -1.2, 0.3, 2.0], requires_grad=True)
    out = box.apply(par, theta)
    vals = box.values(theta.detach())
    assert torch.equal(out.mark["cp_kmin"], vals[0].reshape(1))
    assert torch.equal(out.react["rp_rai"], vals[3].reshape(1))
    assert out.react["rp_g"].requires_grad
    bad = ParamBox((TunableParam("wrong", ("react.rp_g",), ("dcqcn.rai",),
                                 1e6, 2e8, log=True),))
    with pytest.raises(AssertionError, match="box inconsistency"):
        bad.to_spec(DCQCN.to_spec(), np.zeros(1))
    assert box_for(DCQCN).names == box.names
    assert "thresh" in box_for(PAPER_CONFIG).names
    with pytest.raises(ValueError, match="no default ParamBox"):
        box_for(PAPER_CONFIG.to_spec().replace(reaction="swift"))


def test_resolve_objective_forms():
    _, sig = objectives.resolve("goodput")
    assert sig == "name:goodput"
    _, sig = objectives.resolve({"goodput": 1, "jain": 0.5})
    assert sig.startswith("weighted:")
    assert objectives.resolve("default")[1].startswith("weighted:")
    with pytest.raises(KeyError):
        objectives.resolve("nope")
    with pytest.raises(KeyError):
        objectives.weighted({"nope": 1.0})


def test_summary_tuner_metrics_match_reference():
    """``jain_index``, ``p99_slowdown`` and ``ctrl_per_mb`` of the port's
    hard results against the reference's (rtol 2e-3, the golden suite's)."""
    import repro.core as R
    port = _small_sweep().run(n_steps=N_STEPS, device="cpu").summary()
    ref = R.Sweep.grid(
        configs={s.name: R.PAPER_CONFIG.replace(scheme=s)
                 for s in (R.CCScheme.DCQCN, R.CCScheme.DCQCN_REV)},
        scenarios={"in4": R.ScenarioSpec.incast(4, **FAST)}).run(
            n_steps=N_STEPS).summary()
    for name, row in port.items():
        assert 0.0 <= row["jain_index"] <= 1.0 and row["p99_slowdown"] >= 1
        for k in ("jain_index", "p99_slowdown", "ctrl_per_mb"):
            np.testing.assert_allclose(row[k], ref[name][k], rtol=2e-3,
                                       err_msg=f"{name}.{k}")


def test_hard_objective_consistent_with_soft_at_tau0():
    ev = Evaluator(TuneProblem(DCQCN, ScenarioSpec.incast(3, **FAST),
                               n_steps=300, trace_every=50, device="cpu"))
    theta = ev.box.encode(ev.spec)
    v_soft, _ = ev.value_and_grad(theta, 0.0)
    v_hard = float(ev.hard_values(theta[None])[0])
    np.testing.assert_allclose(v_soft, v_hard, rtol=2e-3, atol=1e-4)
