"""The port's CC-stage registry (``repro_torch.core.cc``) against the
reference's (``repro.core.cc``), stage by stage on identical contexts.

Contexts are made from a numpy seed for a batch of R runs, each run with
its own config; the port evaluates the batch at once, the reference run
by run with its unbatched stages (eager, so neither side fuses a
multiply-add).  Tolerance: exact — every stage, and the per-run
``dispatch`` select, must agree bitwise on every output and state key.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)      # tiny tensors: threads only add overhead

import jax.numpy as jnp                                     # noqa: E402

from repro.core import cc as ccR                            # noqa: E402
from repro.core.fluid import step_params as ref_step_params  # noqa: E402
from repro.core.params import (CCSpec as SpecR,              # noqa: E402
                               DCQCNParams as DR, RevParams as RR)
from repro_torch.core import cc as ccP                      # noqa: E402
from repro_torch.core.fluid import step_params                # noqa: E402
from repro_torch.core.params import (CCSpec as SpecP,         # noqa: E402
                                     DCQCNParams as DP, RevParams as RP)

R, F, H, D = 4, 96, 6, 9


def _specs(CCSpec, DCQCN, Rev):
    """R configs with distinct constants, one per run."""
    out = []
    for r in range(R):
        out.append(CCSpec(
            dcqcn=DCQCN(kmin=15 * 1024.0 * (1 + r % 2),
                        kmax=60 * 1024.0, pmax=0.25 + 0.2 * r,
                        g=1 / (64 * (r + 1)), rai=5e6 * (r + 1),
                        cnp_window=10e-6 * (r + 1)),
            rev=Rev(erp_settle=0.9 + 0.02 * r, erp_rai=5e12 / (r + 1),
                    enp_coalesce=2e-6 * (r + 1), ecp_fairness_slack=1.1)))
    return out


def _params():
    port = step_params(_specs(SpecP, DP, RP), device="cpu")
    ref = [ref_step_params(s) for s in _specs(SpecR, DR, RR)]
    return port, ref


def _mark_ctx(rng):
    B1 = rng.uniform(0, 120e3, (R, F, H)).astype(np.float32)
    holds = rng.rand(R, F, H) < 0.7
    grant = np.where(rng.rand(R, F, H) < 0.2, np.inf,
                     rng.uniform(0, 12.5e9, (R, F, H))).astype(np.float32)
    return dict(B1_w=B1, present=rng.rand(R, F, H) < 0.6,
                holds_queue=holds,
                dem_next=rng.uniform(0, 12.5e9, (R, F, H)).astype(np.float32),
                grant_next=grant,
                over_next=(rng.rand(R, F, H) < 0.5).astype(np.float32))


def _state(rng):
    return {"slope_acc": rng.uniform(0, 1, (R, F)).astype(np.float32),
            "swift_cool": (rng.uniform(0, 5e-5, (R, F))
                           * (rng.rand(R, F) < 0.5)).astype(np.float32)}


def _tree_equal(a, b, ctx):
    if isinstance(a, dict):
        assert set(a) == set(b), ctx
        for k in a:
            _tree_equal(a[k], b[k], ctx + (k,))
    elif isinstance(a, tuple):
        for i, (x, y) in enumerate(zip(a, b)):
            _tree_equal(x, y, ctx + (i,))
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b)), ctx


def _run_ref(registry, stage, par_r, ctx_r, state_r):
    fam = {"marking": "mark", "notification": "notif",
           "reaction": "react"}[registry.family]
    return stage.step(getattr(par_r, fam), ctx_r, state_r)


@pytest.mark.parametrize("name", ccR.MARKING.names())
def test_marking_stage_matches_reference(name):
    rng = np.random.RandomState(1)
    ctx, state = _mark_ctx(rng), _state(rng)
    port_par, ref_pars = _params()
    pctx = ccP.MarkCtx(**{k: torch.from_numpy(v) for k, v in ctx.items()},
                       port_buffer=port_par.port_buffer,
                       line_rate=port_par.line_rate)
    pstate = {k: torch.from_numpy(v) for k, v in state.items()}
    (mark, sev), upd = ccP.MARKING.get(name).step(port_par.mark, pctx,
                                                  pstate)
    for r in range(R):
        par = ref_pars[r]
        rctx = ccR.MarkCtx(**{k: jnp.asarray(v[r]) for k, v in ctx.items()},
                           port_buffer=par.port_buffer,
                           line_rate=par.line_rate, tau=par.temperature)
        (m, s), u = _run_ref(ccR.MARKING, ccR.MARKING.get(name), par, rctx,
                             {k: jnp.asarray(v[r]) for k, v in state.items()})
        _tree_equal((m, s, u), (mark[r], sev[r], {k: v[r] for k, v in
                                                   upd.items()}), (name, r))


@pytest.mark.parametrize("name", ccR.NOTIFICATION.names())
def test_notification_stage_matches_reference(name):
    rng = np.random.RandomState(2)
    mark_fh = (rng.rand(R, F, H) < 0.1).astype(np.float32)
    marked = mark_fh.max(axis=2)
    np_tmr = rng.uniform(0, 60e-6, (R, F)).astype(np.float32)
    hops = rng.randint(1, H + 1, (R, F)).astype(np.int32)
    rtt = rng.randint(2, D, (R, F)).astype(np.int32)
    t = rng.randint(0, 1000, R).astype(np.int32)
    port_par, ref_pars = _params()
    pctx = ccP.NotifCtx(marked=torch.from_numpy(marked),
                        mark_fh=torch.from_numpy(mark_fh),
                        np_tmr_t=torch.from_numpy(np_tmr),
                        hops=torch.from_numpy(hops).long(),
                        rtt=torch.from_numpy(rtt).long(),
                        t=torch.from_numpy(t), D=D)
    out, upd = ccP.NOTIFICATION.get(name).step(port_par.notif, pctx, {})
    for r in range(R):
        par = ref_pars[r]
        rctx = ccR.NotifCtx(marked=jnp.asarray(marked[r]),
                            mark_fh=jnp.asarray(mark_fh[r]),
                            np_tmr_t=jnp.asarray(np_tmr[r]),
                            hops=jnp.asarray(hops[r]), rtt=jnp.asarray(rtt[r]),
                            t=jnp.asarray(t[r]), D=D, tau=par.temperature)
        o, u = _run_ref(ccR.NOTIFICATION, ccR.NOTIFICATION.get(name), par,
                        rctx, {})
        _tree_equal(tuple(o), tuple(x[r] for x in out), (name, r))
        assert u == {} and upd == {}


def _react_ctx(rng):
    f = lambda lo, hi: rng.uniform(lo, hi, (R, F)).astype(np.float32)  # noqa
    return dict(rate=f(1e6, 12.5e9), rp_target=f(1e6, 12.5e9),
                alpha=f(0, 1), byte_cnt=f(0, 1.2e7), tmr=f(0, 6e-5),
                alpha_tmr=f(0, 6e-5),
                bc_stage=rng.randint(0, 9, (R, F)).astype(np.int32),
                t_stage=rng.randint(0, 9, (R, F)).astype(np.int32),
                hold=f(0, 6e-5) * (rng.rand(R, F) < 0.5),
                cnp=(rng.rand(R, F) < 0.3).astype(np.float32),
                tgt_rx=f(1e6, 12.5e9), qdelay=f(0, 1e-5),
                jitter=f(-1, 1), gen_rate=f(0, 20e9))


@pytest.mark.parametrize("name", ccR.REACTION.names())
def test_reaction_stage_matches_reference(name):
    rng = np.random.RandomState(3)
    ctx, state = _react_ctx(rng), _state(rng)
    port_par, ref_pars = _params()
    dt = torch.tensor(1e-6, dtype=torch.float32)
    pctx = ccP.ReactCtx(**{k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in ctx.items()},
                        line_rate=port_par.line_rate, dt=dt)
    pstate = {k: torch.from_numpy(v) for k, v in state.items()}
    out, upd = ccP.REACTION.get(name).step(port_par.react, pctx, pstate)
    for r in range(R):
        par = ref_pars[r]
        rctx = ccR.ReactCtx(**{k: jnp.asarray(v[r]) for k, v in ctx.items()},
                            line_rate=par.line_rate, dt=jnp.float32(1e-6),
                            tau=par.temperature)
        o, u = _run_ref(ccR.REACTION, ccR.REACTION.get(name), par, rctx,
                        {k: jnp.asarray(v[r]) for k, v in state.items()})
        _tree_equal((tuple(o), u), (tuple(x[r] for x in out),
                                    {k: v[r] for k, v in upd.items()}),
                    (name, r))


def test_dispatch_selects_per_run():
    """Runs with different reaction codes in one batch: dispatch picks
    each run's stage and passes unselected stage state through."""
    rng = np.random.RandomState(4)
    ctx, state = _react_ctx(rng), _state(rng)
    port_par, _ = _params()
    codes = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    dt = torch.tensor(1e-6, dtype=torch.float32)
    pctx = ccP.ReactCtx(**{k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in ctx.items()},
                        line_rate=port_par.line_rate, dt=dt)
    pstate = {k: torch.from_numpy(v) for k, v in state.items()}
    out, fam = ccP.dispatch(ccP.REACTION, codes, port_par.react, pctx,
                            pstate)
    for r, stage in enumerate(ccP.REACTION.stages()):
        o, u = stage.step(port_par.react, pctx, pstate)
        for a, b in zip(out, o):
            assert torch.equal(a[r], b[r]), (stage.name, r)
        cool = u.get("swift_cool", pstate["swift_cool"])
        assert torch.equal(fam["swift_cool"][r], cool[r])


def test_registry_codes_and_params_match_reference():
    for fr, fp in zip(ccR.FAMILIES, ccP.FAMILIES):
        assert fr.names() == fp.names()
        for s in fr.stages():
            assert fp.code(s.name) == s.code
            assert fp.get(s.name).consumes_marks == s.consumes_marks
    port_par, ref_pars = _params()
    for fam in ("mark", "notif", "react"):
        got = getattr(port_par, fam)
        for r, par in enumerate(ref_pars):
            want = getattr(par, fam)
            assert set(got) == set(want)
            for k in want:
                assert np.array_equal(got[k][r].numpy(), np.asarray(want[k]))
                assert got[k].dtype == (torch.int32 if np.asarray(
                    want[k]).dtype == np.int32 else torch.float32)
