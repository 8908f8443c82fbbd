"""The port's fluid step (``repro_torch.core.fluid``) against the
reference's, one step at a time from identical state.

The reference stages its batch (``Sweep._prepare``) and steps it with
its vmapped ``fluid_step``; every step the port is handed the very same
state (``repro_torch.convert``) and takes one step of its own.  That is
done along the first 60 steps of the 18-point golden grid (3 schemes x
2 fabrics x min/valiant/ugal) and of its two-VC variant, so the states
compared cover queue build-up, marking, CNP arrival and path changes.
Beside it the port also runs the same 60 steps free, from its own state
only, and that trajectory is held to the reference's step by step.

Tolerance:
  * one step from identical state: continuous fields within 2 ulp of the
    field's scale (max |ref| over the array).  Reason: XLA contracts
    multiply-adds into one FMA (the crossing-rate EWMA
    ``(1-b)*est + b*T/dt``, the severity payload) and divides by a
    constant through its reciprocal (``inst_thr``); the port rounds each
    operation, so single sites differ by 1 ulp;
  * the free trajectory after t steps: 2 * t ulp of the field's scale,
    since such a difference can be made anew on every step and carried;
  * discrete fields exact in both: stage counters, path choices, step
    counter, pause bits, the delay line, marks, CNPs and the trace
    counters.  (No gate input on these grids lies within the bound of
    its threshold; a flip would fail here.)

Inside the port the engines must agree bitwise: the dense-CSR walk, the
segment sum and the scatter path, and ``use_kernels`` True and False.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)      # tiny tensors: threads only add overhead

import jax                                                  # noqa: E402

from repro.core import fluid as fluidR                      # noqa: E402
from repro.core.fluid import dense_reduce_rows as dense_rows_R  # noqa: E402
from repro_torch import convert                             # noqa: E402
from repro_torch.core import PAPER_CONFIG, ScenarioSpec, cc  # noqa: E402
from repro_torch.core import fluid as fluidP                 # noqa: E402
from test_fluid_fused import _grid, _grid_v2                # noqa: E402

EPS32 = float(np.finfo(np.float32).eps)
ULP_BOUND = 2.0
N_STEPS = 60


def port_grid(n_vcs: int = 1):
    """The golden suite's 18-point grid built by the port (the same
    seeds and shapes as ``test_fluid_fused._grid`` / ``_grid_v2``)."""
    from repro_torch.core import CCScheme, CCSpec, Sweep
    from repro_torch.core.params import LinkParams
    from repro_torch.core.workloads import group_shift
    from repro_torch.net import FabricSpec
    dfly = FabricSpec.dragonfly(a=2, p=2, h=2)
    ft = FabricSpec.fat_tree(4, taper=2)
    scen = {"dfly_adv": group_shift(5, 4, t_stop=0.5e-3).spec(
                fabric=dfly, n_paths=4, route_seed=0, label="dfly_adv"),
            "ft_perm": ScenarioSpec.permutation(
                16, seed=2, fabric=ft, n_paths=4, route_seed=0,
                t_start=0.0, t_stop=0.5e-3, label="ft_perm")}
    routings = ("min", "valiant", "ugal")
    if n_vcs == 1:
        cfgs = {f"{s.name}/{r}": PAPER_CONFIG.replace(scheme=s, routing=r)
                for s in CCScheme for r in routings}
    else:
        stages = {"PFC_ONLY": ("cp", "np", "pfc"),
                  "DCQCN": ("cp", "np", "rp"),
                  "DCQCN_REV": ("ecp", "enp", "erp")}
        cfgs = {f"{s}/{r}": CCSpec(marking=m, notification=n, reaction=x,
                                   routing=r, link=LinkParams(n_vcs=n_vcs))
                for s, (m, n, x) in stages.items() for r in routings}
    return Sweep.grid(configs=cfgs, scenarios=scen)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _continuous_ok(a: np.ndarray, b: np.ndarray) -> float:
    """max |a - b| in ulps of the field's scale (max |a|)."""
    scale = max(float(np.abs(a).max(initial=0.0)), 1e-30)
    return float(np.abs(a.astype(np.float64) - b).max(initial=0.0)
                 / (EPS32 * scale))


def _compare(ref_state, ref_trace, port_state, port_trace, where,
             bound=ULP_BOUND):
    for f in fluidR.FluidState._fields:
        a, b = getattr(ref_state, f), getattr(port_state, f)
        items = a.items() if isinstance(a, dict) else [(f, a)]
        for k, x in items:
            y = b[k] if isinstance(b, dict) else b
            assert x.shape == y.shape, (where, k)
            if x.dtype.kind == "f" and f not in ("paused", "trig_buf"):
                assert _continuous_ok(x, y) <= bound, (where, k)
            else:
                assert np.array_equal(x, y), (where, k)
    for f in ref_trace._fields:
        x = np.asarray(getattr(ref_trace, f))
        y = getattr(port_trace, f).numpy()
        if f in ("delivered", "rate", "inst_thr", "max_q", "pause_time",
                 "vc_stall"):
            assert _continuous_ok(x, y) <= bound, (where, f)
        else:
            assert np.array_equal(x, y), (where, f)


def _stepwise(sweep, n_steps=N_STEPS):
    static, (st, sd, par), _, _ = sweep._prepare(n_steps, reduce="fused")
    _, _, dt, n_sw, _, dense_rows, _, _, n_vcs, _, _ = static
    assert dense_rows > 0
    ref_step = jax.jit(jax.vmap(lambda s, d, p: fluidR.fluid_step(
        s, d, p, dt=dt, n_switches=n_sw, reduce="fused",
        dense_rows=dense_rows, n_vcs=n_vcs)))
    sd_p = convert.scenario_dev_from_numpy(_np(sd), device="cpu")
    par_p = convert.step_params_from_numpy(_np(par), device="cpu")
    plan = fluidP.reduce_plan(sd_p, n_switches=n_sw, n_vcs=n_vcs,
                              dense_rows=dense_rows, dt=dt)
    packed = cc.pack_react_rows(par_p.react, par_p.line_rate, plan.dt)
    def port_step(state):
        return fluidP._step_body(state, sd_p, par_p, plan, n_switches=n_sw,
                                 reduce="fused", n_vcs=n_vcs,
                                 packed_react=packed)

    free = convert.state_from_numpy(_np(st), device="cpu")
    events = {"cnp": 0, "marked": 0, "nonmin": 0}
    for t in range(n_steps):
        nxt, tr = ref_step(st, sd, par)
        ref_next = _np(nxt)
        mine, mtr = port_step(convert.state_from_numpy(_np(st),
                                                       device="cpu"))
        _compare(ref_next, tr, convert.state_to_numpy(mine), mtr,
                 ("step", t))
        free, ftr = port_step(free)
        _compare(ref_next, tr, convert.state_to_numpy(free), ftr,
                 ("free", t), bound=ULP_BOUND * (t + 1))
        events["cnp"] += int(np.asarray(tr.cnp).sum())
        events["marked"] += int(np.asarray(tr.marked).sum())
        events["nonmin"] += int(np.asarray(tr.n_nonmin).sum())
        st = nxt
    # the trajectory must actually exercise the gates it claims to
    assert min(events.values()) > 0, events


def test_steps_match_reference_on_golden_grid():
    _stepwise(_grid())


def test_steps_match_reference_at_two_vcs():
    _stepwise(_grid_v2())


def test_fluid_step_entry_point_matches_step_body():
    """``fluid_step`` (builds its own plan and rows) = the staged step."""
    stg = port_grid().subset(range(6)).prepare(10, device="cpu")
    st = stg.state
    for _ in range(5):
        st, _ = stg.step(st)
    a, ta = stg.step(st)
    b, tb = fluidP.fluid_step(st, stg.sd, stg.par, dt=1e-6,
                              n_switches=stg.n_switches,
                              dense_rows=stg.dense_rows, n_vcs=1)
    for x, y in zip(convert.state_to_numpy(a)[:-2],
                    convert.state_to_numpy(b)[:-2]):
        assert np.array_equal(x, y)
    for x, y in zip(ta, tb):
        assert torch.equal(x, y)


@pytest.mark.parametrize("n_vcs", [1, 2])
def test_port_engines_agree_bitwise(n_vcs):
    """Dense-CSR walk = segment sum = scatter, and use_kernels True =
    False, inside the port (final states and every trace)."""
    sweep = port_grid(n_vcs)
    runs = [sweep.run(n_steps=40, device="cpu"),
            sweep.run(n_steps=40, device="cpu", dense_rows=0),
            sweep.run(n_steps=40, device="cpu", reduce="scat"),
            sweep.run(n_steps=40, device="cpu", use_kernels=True)]
    base = runs[0]
    for other in runs[1:]:
        for f in base.traces._fields:
            assert np.array_equal(getattr(base.traces, f),
                                  getattr(other.traces, f)), f
        for x, y in zip(base.final[:-2], other.final[:-2]):
            assert np.array_equal(x, y)


def test_host_layer_matches_reference():
    """The port's copied host layer builds the reference's arrays:
    scenario tensors, incidence, jitter, initial state, step params."""
    import repro.core as R
    from test_fluid_fused import _grid_scenarios
    for spec_r in _grid_scenarios().values():
        spec_p = ScenarioSpec(**{f: getattr(spec_r, f) for f in (
            "kind", "arity", "roll", "n_senders", "dst", "victim", "pairs",
            "n_flows", "seed", "t_start", "t_stop", "volume", "nic_buffer",
            "gen_rate", "label", "n_paths", "route_seed", "vc_mode",
            "flow_src", "flow_dst", "flow_t_start", "flow_t_stop",
            "flow_volume", "flow_rate", "flow_nic_buffer", "flow_vc",
            "flow_victim")}, fabric=_port_fabric(spec_r.fabric))
        for cfg_r, cfg_p in ((R.PAPER_CONFIG, PAPER_CONFIG),):
            a, b = spec_r.build(cfg_r), spec_p.build(cfg_p)
            for f in a._fields:
                x, y = getattr(a, f), getattr(b, f)
                assert np.array_equal(np.asarray(x), np.asarray(y)), f
            sd_r = _np(R.scenario_device(a))
            sd_p = fluidP.scenario_arrays(convert.scenario_from_numpy(a))
            for f in sd_r._fields:
                assert np.array_equal(np.asarray(getattr(sd_r, f)),
                                      sd_p[f]), f
            st_r = _np(R.init_state(a, cfg_r))
            st_p = convert.state_to_numpy(
                fluidP.init_state(b, cfg_p, device="cpu"))
            for f in ("qh", "rate", "alpha", "np_tmr", "trig_buf", "paused"):
                assert np.array_equal(getattr(st_r, f), getattr(st_p, f)[0])
            assert dense_rows_R(a) == fluidP.dense_reduce_rows(b)


def _port_fabric(fab):
    from repro_torch.net import FabricSpec
    return FabricSpec(**{f: getattr(fab, f) for f in (
        "kind", "arity", "roll", "m", "w", "a", "p", "h", "groups",
        "rate_scales")})


def test_make_step_fn_needs_a_device_or_a_gpu(monkeypatch):
    scn = ScenarioSpec.paper_incast(roll=0).build(PAPER_CONFIG)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fluidP.make_step_fn(scn, PAPER_CONFIG)
    # the builders it pairs with default to the card too
    for build in (lambda: fluidP.init_state(scn, PAPER_CONFIG),
                  lambda: fluidP.scenario_device(scn),
                  lambda: fluidP.step_params(PAPER_CONFIG)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    step = fluidP.make_step_fn(scn, PAPER_CONFIG, device="cpu")
    st, tr = step(fluidP.init_state(scn, PAPER_CONFIG, device="cpu"))
    assert st.t.tolist() == [1]


def test_ordered_engines_refuse_cuda_tensors():
    """The scatter engine has no ordered CUDA form: it raises on a
    non-CPU device instead of running unordered, and points at the
    segment_reduce kernel the other engines use there."""
    with pytest.raises(NotImplementedError, match="segment_reduce"):
        fluidP._cpu_only("reduce='scat'", torch.empty(1, device="meta"))
