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
  * the launch geometry (``mega_geometry``) at every cell chip_smoke
    runs: the cluster size rule and its residency check, each flow,
    wire, queue and switch owned once, every pushed row placed once in
    its owner's CSR order, the shared memory within the card, staging
    dropped before a refusal;
  * the kernel's operand layout (``csrc/fluid_step.cu``) against the
    wrapper's ctypes mirror, read from the source.

The CUDA kernel runs only on a card: ``test_megastep_on_cuda`` holds it
bitwise to the flow tier there (cluster sizes 1-8, two VCs) and skips
elsewhere.
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


# ---------------------------------------------------------------------------
# the launch geometry: cluster size, partition, shared memory
# ---------------------------------------------------------------------------

def _chip_smoke():
    """``chip_smoke.py`` at the repo root (its module level imports no
    torch and touches no card): the cells the card runs."""
    import importlib.util
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cell(name: str):
    cs = _chip_smoke()
    if name == "paper":
        scen = {f"window{r}": ScenarioSpec.paper_incast(roll=r)
                for r in (0, 1)}
        scen |= {f"volume{r}": ScenarioSpec.paper_incast_volume(roll=r)
                 for r in (0, 1)}
        return Sweep.grid(configs={s.name: PAPER_CONFIG.replace(scheme=s)
                                   for s in CCScheme}, scenarios=scen)
    return {"golden_routing": lambda: cs._golden_routing()[0],
            "pathology": lambda: cs._golden_pathology()[0],
            "dc": cs._dc_sweep, "hotspot": cs._hotspot_sweep,
            "ragged129": lambda: cs._flows_sweep(129),
            "vc2": cs._vc2_sweep}[name]()


@pytest.mark.parametrize("cell", ["paper", "golden_routing", "pathology",
                                  "dc", "hotspot", "ragged129", "vc2"])
def test_mega_geometry_covers_each_cell_once(cell):
    """At each cell chip_smoke runs: the cluster size rule, each flow,
    wire (with its V queues) and switch owned by exactly one CTA, the
    caps holding every CTA's slice of every run, the shared memory
    within the card's 232,448 B, and every (flow, candidate, hop) row
    pushed to exactly one place of its queue's owner."""
    stg = _cell(cell).prepare(1, device="cpu", use_kernels="mega")
    sd, plan = stg.sd, stg.plan
    R, F, K, H = sd.alt_routes.shape
    L = sd.cap_ext.shape[1] - 1
    S = sd.red_off.shape[1] - 2
    V, NSW = S // L, stg.n_switches
    packed = cc.pack_react_rows(stg.par.react, stg.par.line_rate, plan.dt)
    mp = FS.mega_plan(stg.par, packed, plan.dt, sd=sd, plan=plan)
    geo = mp.geometry
    c = geo.cluster
    assert c == FS.cluster_size(R, F) == min(8, max(1, 132 // R),
                                              max(1, -(-F // 384)))
    off = sd.red_off.numpy()
    po = plan.pool_off.numpy()
    for n, cap in ((F, geo.flow_cap), (L, geo.q_cap // V),
                   (NSW, None)):
        cut = FS.slices(n, c)
        assert cut[0] == 0 and cut[-1] == n
        sizes = np.diff(cut)
        assert (sizes >= 0).all() and sizes.sum() == n   # each item once
        if cap is not None:
            assert sizes.max() == cap
    qs = np.asarray(FS.slices(L, c)) * V
    ws = FS.slices(NSW, c)
    assert (off[:, qs[1:]] - off[:, qs[:-1]]).max() == geo.rows_cap
    assert (po[:, ws[1:]] - po[:, ws[:-1]]).max() == geo.pool_cap
    words = FS.smem_words(
        S=S, L=L, NSW=NSW, V=V, K=K, H=H, q_cap=geo.q_cap,
        flow_cap=geo.flow_cap, rows_cap=geo.rows_cap, pool_cap=geo.pool_cap,
        push_rows=geo.push_rows, stage_paths=geo.stage_paths)
    assert geo.smem_bytes == 4 * words <= FS.MEGA_SMEM_CAP == 232_448
    assert geo.push_rows and geo.stage_paths      # all fit at these cells
    assert c == {"paper": 1, "golden_routing": 1, "pathology": 1, "dc": 3,
                 "hotspot": 8, "ragged129": 1, "vc2": 1}[cell]
    pos = mp.path_pos.reshape(R, -1).numpy().astype(np.int64)
    perm = sd.red_perm.numpy()
    seg = sd.red_seg.numpy()
    for r in range(R):
        queue = np.empty(F * K * H, np.int64)
        queue[perm[r]] = seg[r]                       # each row's queue
        owner, local = pos[r] >> 24, pos[r] & 0xffffff
        pad = queue == S
        assert (pos[r][pad] == -1).all() and (pos[r][~pad] >= 0).all()
        o, q = owner[~pad], queue[~pad]
        assert ((qs[o] <= q) & (q < qs[o + 1])).all()  # the queue's owner
        flat = off[r, qs[o]] + local[~pad]             # back to CSR order
        assert np.array_equal(np.sort(flat), np.arange(off[r, S]))
        assert (local[~pad] < geo.rows_cap).all()


def test_mega_cluster_size_keeps_every_run_resident():
    """c = min(8, max(1, 132 // R), ceil(F / 384)), lowered while the card
    would hold fewer than R clusters at once (the residency table is the
    H100's cudaOccupancyMaxActiveClusters at one CTA an SM)."""
    assert [FS.cluster_size(R, 4096) for R in (1, 2, 9, 12, 18, 36, 66, 67,
                                               132, 500)] == \
        [8, 8, 8, 8, 7, 3, 2, 1, 1, 1]
    assert [FS.cluster_size(12, F) for F in (1, 5, 384, 385, 769, 8193)] == \
        [1, 1, 1, 2, 3, 8]
    resident = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}
    off = np.zeros((1, 2 * 10 + 2), np.int64)
    po = np.zeros((1, 4 + 1), np.int64)
    for R, want in ((9, 8), (12, 8), (18, 5), (36, 3), (132, 1)):
        geo = FS.mega_geometry(R, 4096, 1, 4, 10, 2, 4,
                               np.repeat(off, R, 0), np.repeat(po, R, 0),
                               max_active=lambda c, smem: resident[c])
        assert geo.cluster == want, (R, geo)
    geo = FS.mega_geometry(18, 16, 1, 4, 10, 2, 4, np.repeat(off, 18, 0),
                           np.repeat(po, 18, 0), cluster=7,
                           max_active=lambda c, smem: resident[c])
    assert geo.cluster == 7                           # forced: no check
    with pytest.raises(ValueError, match="MEGA_MAX_CLUSTER"):
        FS.mega_geometry(18, 16, 1, 4, 10, 2, 4, np.repeat(off, 18, 0),
                         np.repeat(po, 18, 0), cluster=9)


def test_mega_geometry_drops_staging_before_refusing(monkeypatch):
    """Under a smaller cap the staged paths go first, then the pushed
    rows (the walk gathers them from global memory); only the replicas
    themselves past MEGA_SMEM_CAP refuse."""
    stg = _paper_sweep().prepare(1, device="cpu", use_kernels="mega")
    R, F, K, H = stg.sd.alt_routes.shape
    L = stg.sd.cap_ext.shape[1] - 1
    off, po = stg.sd.red_off.numpy(), stg.plan.pool_off.numpy()
    args = (R, F, K, H, L, 1, stg.n_switches, off, po)
    full = FS.mega_geometry(*args)
    assert full.push_rows and full.stage_paths
    monkeypatch.setattr(FS, "MEGA_SMEM_CAP", full.smem_bytes - 4)
    geo = FS.mega_geometry(*args)
    assert geo.push_rows and not geo.stage_paths
    kw = dict(S=L, L=L, NSW=stg.n_switches, V=1, K=K, H=H, q_cap=full.q_cap,
              flow_cap=full.flow_cap, rows_cap=full.rows_cap,
              pool_cap=full.pool_cap, stage_paths=False)
    base = 4 * FS.smem_words(**kw, push_rows=False)
    monkeypatch.setattr(FS, "MEGA_SMEM_CAP", base)
    geo = FS.mega_geometry(*args)
    assert not (geo.push_rows or geo.stage_paths)
    assert geo.smem_bytes == base
    monkeypatch.setattr(FS, "MEGA_SMEM_CAP", base - 4)
    with pytest.raises(ValueError, match="MEGA_SMEM_CAP"):
        FS.mega_geometry(*args)


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
    assert f"kThreads = {FS.MEGA_THREADS};" in src
    assert f"kMaxCluster = {FS.MEGA_MAX_CLUSTER};" in src


@pytest.mark.cuda
def test_megastep_on_cuda(monkeypatch):
    """On a card: megastep and megastep_block bitwise equal to the flow
    tier on the golden grid (at the plan's cluster size, forced to every
    size 1-8, and with paths and then pushed rows left out of shared
    memory) and on the two-VC grid, and counted."""
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
    packed = cc.pack_react_rows(stg.par.react, stg.par.line_rate,
                                stg.plan.dt)
    for c in range(1, FS.MEGA_MAX_CLUSTER + 1):
        mp = FS.mega_plan(stg.par, packed, stg.plan.dt, sd=stg.sd,
                          plan=stg.plan, cluster=c)
        x = y = stg.state
        for _ in range(5):
            x, tx = stg.step(x)
            y, ty = FS.megastep(y, stg.sd, stg.par, stg.plan, mp, body=None,
                                n_switches=stg.n_switches, n_vcs=1)
            for u, v in zip(tx, ty):
                assert torch.equal(u, v), c
        assert FS.GEOMETRY["megastep"].cluster == c
    # one CTA a run, so the cap the shape check holds (MEGA_SMEM_CAP >=
    # mega_footprint) can leave out the paths, then the pushed rows
    full = FS.mega_plan(stg.par, packed, stg.plan.dt, sd=stg.sd,
                        plan=stg.plan, cluster=1).geometry
    L = stg.sd.cap_ext.shape[1] - 1
    need = FS.mega_footprint(L, L, stg.n_switches, 1)
    for cap, flags in ((full.smem_bytes - 4, (True, False)),
                       (need, (False, False))):
        monkeypatch.setattr(FS, "MEGA_SMEM_CAP", cap)
        mp = FS.mega_plan(stg.par, packed, stg.plan.dt, sd=stg.sd,
                          plan=stg.plan, cluster=1)
        assert (mp.geometry.push_rows, mp.geometry.stage_paths) == flags
        x = y = stg.state
        for _ in range(5):
            x, tx = stg.step(x)
            y, ty = FS.megastep(y, stg.sd, stg.par, stg.plan, mp, body=None,
                                n_switches=stg.n_switches, n_vcs=1)
            for u, v in zip(tx, ty):
                assert torch.equal(u, v), flags
    monkeypatch.undo()
    sweep = port_grid(2)
    a = sweep.run(n_steps=60, trace_every=10, device=dev)
    b = sweep.run(n_steps=60, trace_every=10, device=dev, use_kernels="mega")
    for f in a.traces._fields:
        assert np.array_equal(getattr(a.traces, f), getattr(b.traces, f)), f
