"""The port's whole-step tier ``use_kernels="mega"``
(``repro_torch.kernels.fluid_step``) against the reference's, on the
CPU, where ``megastep`` / ``megastep_block`` run their plain versions
(the port's step and the host's window fold, as the reference's
interpret mode runs its step body).

  * ``fluid_step(use_kernels="mega")``, one step at a time from the
    reference's own state, against the reference's ``use_kernels=
    "mega", interpret=True`` on the 18-point golden grid: within the
    per-step bound of ``test_torch_fluid`` (2 ulp of each field's
    scale; discrete fields exact);
  * ``simulator.run(use_kernels="mega", trace_every=10)`` for 60 steps
    against the reference's at the golden tolerances (floats rtol 2e-3,
    counters within 2% or +-2) and bitwise against the port's flow tier;
  * the refusals: mega with ``reduce="pallas"``, with ``temperature >
    0``, with a registered stage the kernel has no body for, and past
    ``MEGA_SMEM_CAP`` / ``MEGA_MAX_HOPS``;
  * the kernel's operand layout (``csrc/fluid_step.cu``) against the
    wrapper's ctypes mirror, read from the source.

The CUDA kernel runs only on a card: ``test_megastep_on_cuda`` holds it
bitwise to the flow tier there and skips elsewhere.
"""

import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)      # tiny tensors: threads only add overhead

import jax                                                  # noqa: E402

import repro.core as R                                      # noqa: E402
from repro.core import fluid as fluidR                      # noqa: E402
from repro.core import simulator as simR                    # noqa: E402
from repro_torch import convert                             # noqa: E402
from repro_torch.core import (CCScheme, PAPER_CONFIG, ScenarioSpec,  # noqa: E402
                              Sweep, cc, simulator)
from repro_torch.core import fluid as fluidP                 # noqa: E402
from repro_torch.kernels import fluid_step as FS            # noqa: E402
from test_fluid_fused import _grid                          # noqa: E402
from test_torch_fluid import _compare, _np, port_grid       # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src", "repro_torch", "csrc", "fluid_step.cu")


def test_mega_steps_match_reference_on_golden_grid():
    sweep = _grid()
    n_steps = 25
    static, (st, sd, par), _, _ = sweep._prepare(n_steps, reduce="fused")
    _, _, dt, n_sw, _, dense_rows, _, _, n_vcs, _, _ = static
    ref_step = jax.jit(jax.vmap(lambda s, d, p: fluidR.fluid_step(
        s, d, p, dt=dt, n_switches=n_sw, reduce="fused",
        dense_rows=dense_rows, use_kernels="mega", interpret=True,
        n_vcs=n_vcs)))
    sd_p = convert.scenario_dev_from_numpy(_np(sd), device="cpu")
    par_p = convert.step_params_from_numpy(_np(par), device="cpu")
    for t in range(n_steps):
        nxt, tr = ref_step(st, sd, par)
        mine, mtr = fluidP.fluid_step(
            convert.state_from_numpy(_np(st), device="cpu"), sd_p, par_p,
            dt=dt, n_switches=n_sw, dense_rows=dense_rows,
            use_kernels="mega", n_vcs=n_vcs)
        _compare(_np(nxt), tr, convert.state_to_numpy(mine), mtr, ("step", t))
        st = nxt


def test_mega_run_matches_reference_and_flow_tier():
    spec_kw = dict(roll=0, t_start=0.02e-3)
    cfg_r = R.PAPER_CONFIG.replace(scheme=R.CCScheme.DCQCN_REV)
    cfg_p = PAPER_CONFIG.replace(scheme=CCScheme.DCQCN_REV)
    ref = simR.run(R.ScenarioSpec.paper_incast(**spec_kw).build(cfg_r), cfg_r,
                   n_steps=60, trace_every=10, use_kernels="mega",
                   interpret=True)
    scn = ScenarioSpec.paper_incast(**spec_kw).build(cfg_p)
    mega = simulator.run(scn, cfg_p, n_steps=60, trace_every=10,
                         use_kernels="mega", device="cpu")
    flow = simulator.run(scn, cfg_p, n_steps=60, trace_every=10,
                         device="cpu")
    for f in ("delivered", "rate", "inst_thr", "max_q", "n_paused",
              "marked", "cnp", "n_nonmin", "ctrl", "pause_time",
              "vc_stall"):
        a, b, w = getattr(mega, f), getattr(flow, f), getattr(ref, f)
        assert np.array_equal(a, b), f
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, w, rtol=2e-3, atol=1e-9,
                                       err_msg=f)
        else:
            assert np.abs(a.astype(np.int64) - w).max() <= 2, f
    assert mega.summary()["marks"] > 0


def test_mega_sweep_equals_flow_tier_with_vcs():
    """Sweep.run(use_kernels="mega") = the flow tier, bitwise, on the
    two-VC grid (block windows and the per-step path)."""
    sweep = port_grid(2).subset(range(0, 18, 4))
    a = sweep.run(n_steps=40, trace_every=10, device="cpu")
    b = sweep.run(n_steps=40, trace_every=10, device="cpu",
                  use_kernels="mega")
    for f in a.traces._fields:
        assert np.array_equal(getattr(a.traces, f), getattr(b.traces, f)), f
    for x, y in zip(a.final[:-2], b.final[:-2]):
        assert np.array_equal(x, y)


def _paper_sweep():
    return Sweep.grid(configs={s: PAPER_CONFIG.replace(scheme=s)
                               for s in ("PFC_ONLY", "DCQCN")},
                      scenarios=ScenarioSpec.paper_incast(roll=0))


def test_mega_refuses_pallas_and_temperature():
    scn = ScenarioSpec.paper_incast(roll=0).build(PAPER_CONFIG)
    with pytest.raises(ValueError, match="reduce must be 'fused' or 'scat'"):
        _paper_sweep().run(n_steps=10, device="cpu", use_kernels="mega",
                           reduce="pallas")
    with pytest.raises(ValueError, match="reduce must be 'fused' or 'scat'"):
        fluidP.make_step_fn(scn, PAPER_CONFIG, use_kernels="mega",
                            reduce="pallas", device="cpu")
    with pytest.raises(NotImplementedError, match="temperature"):
        _paper_sweep().run(n_steps=10, device="cpu", use_kernels="mega",
                           temperature=0.1)


def test_mega_refuses_an_unknown_registered_stage():
    cc.MARKING.register("test_only_mark", step=cc.MARKING.get("cp").step)
    try:
        with pytest.raises(ValueError, match="test_only_mark"):
            _paper_sweep().run(n_steps=10, device="cpu",
                               use_kernels="mega")
    finally:
        del cc.MARKING._stages["test_only_mark"]
    _paper_sweep().run(n_steps=10, device="cpu", use_kernels="mega")


def test_mega_refuses_past_its_caps(monkeypatch):
    stg = _paper_sweep().prepare(10, device="cpu", use_kernels="mega")
    L = stg.sd.cap_ext.shape[1] - 1
    need = FS.mega_footprint(L, L, stg.n_switches, 1)
    assert 0 < need < FS.MEGA_SMEM_CAP
    monkeypatch.setattr(FS, "MEGA_SMEM_CAP", need - 4)
    with pytest.raises(ValueError, match="MEGA_SMEM_CAP"):
        stg.step(stg.state)
    with pytest.raises(ValueError, match="MEGA_SMEM_CAP"):
        stg.block(stg.state)
    monkeypatch.setattr(FS, "MEGA_SMEM_CAP", need)
    monkeypatch.setattr(FS, "MEGA_MAX_HOPS", 2)
    with pytest.raises(ValueError, match="MEGA_MAX_HOPS"):
        stg.step(stg.state)


def _enum(src: str, name: str) -> list[str]:
    body = re.search(r"enum %s \{(.*?)\};" % name, src, re.S).group(1)
    return [t.split("=")[0].strip() for t in body.split(",") if t.strip()]


def test_kernel_operand_layout_matches_wrapper():
    with open(SRC) as f:
        src = f.read()
    leaves = _enum(src, "Leaf")
    assert leaves[-1] == "N_LEAVES"
    assert [x[2:].lower() for x in leaves[:-1]] == list(FS.STATE_LEAVES)
    frow = _enum(src, "FRow")
    head = frow[:frow.index("FR_RP")]
    assert [x[3:].lower() for x in head] == list(FS.FLOAT_ROW)
    # the packed reaction rows follow in order: rp, erp, swift, end
    follows = [f"FR_{n.upper()}" for n, _ in FS.REACT_ROWS[1:]] + ["FR_COUNT"]
    for (name, width), nxt in zip(FS.REACT_ROWS, follows):
        assert f"{nxt} = FR_{name.upper()} + {width}" in src, name
    assert [x[3:].lower() for x in _enum(src, "IRow")[:-1]] == \
        list(FS.INT_ROW)
    body = re.search(r"struct MegaArgs \{(.*?)\};", src, re.S).group(1)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        for part in decl.split(","):
            m = re.search(r"(\w+)(\[\w+\])?\s*$", part.strip())
            names.append(m.group(1))
    assert names == [f for f, _ in FS.MegaArgs._fields_]
    assert f"kMaxHops = {FS.MEGA_MAX_HOPS};" in src


@pytest.mark.cuda
def test_megastep_on_cuda():
    """On a card: megastep and megastep_block bitwise equal to the flow
    tier on the golden grid, and counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    dev = torch.device("cuda", torch.cuda.current_device())
    sweep = port_grid()
    FS.reset_launch_counts()
    a = sweep.run(n_steps=60, trace_every=10, device=dev)
    b = sweep.run(n_steps=60, trace_every=10, device=dev, use_kernels="mega")
    for f in a.traces._fields:
        assert np.array_equal(getattr(a.traces, f), getattr(b.traces, f)), f
    assert FS.LAUNCHES == {"megastep": 0, "megastep_block": 6}
    stg = sweep.prepare(10, device=dev)
    stm = sweep.prepare(10, device=dev, use_kernels="mega")
    x = y = stg.state
    for _ in range(10):
        (x, tx), (y, ty) = stg.step(x), stm.step(y)
        for u, v in zip(tx, ty):
            assert torch.equal(u, v)
    assert FS.LAUNCHES["megastep"] == 10
