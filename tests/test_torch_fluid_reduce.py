"""The port's ``segment_reduce`` (``repro_torch.kernels.fluid_reduce``)
and the fluid step's segment-sum engines against the reference, on the
CPU.

  * the plain version of the kernel against the reference's Pallas
    ``segment_reduce(..., interpret=True)`` on the shapes of
    ``tests/test_fluid_fused.py``: exact (both add each segment's rows in
    row order from +0.0), empty input and empty segments included;
  * ``reduce="pallas"`` and the ``dense_rows=0`` segment sum, one step at
    a time from the reference's own state (reference ``reduce="pallas",
    interpret=True``), on a 3-scheme paper grid and the 18-point golden
    grid: within the per-step ulp bound of ``test_torch_fluid`` (2 ulp of
    each field's scale; discrete fields exact), and bitwise equal to the
    port's dense-CSR walk;
  * a paper-grid ``Sweep.run(reduce="pallas")`` at the golden suite's
    tolerances (floats rtol 2e-3, counters within 2% or +-2) against the
    reference's.

The CUDA kernel runs only on a card: ``test_segment_reduce_kernel_on_
cuda`` holds it bitwise to the plain version there and skips elsewhere.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)      # tiny tensors: threads only add overhead

import jax                                                  # noqa: E402
import jax.numpy as jnp                                     # noqa: E402

import repro.core as R                                      # noqa: E402
from repro.core import fluid as fluidR                      # noqa: E402
from repro.kernels.fluid_reduce import segment_reduce as seg_R  # noqa: E402
from repro_torch import convert                             # noqa: E402
from repro_torch.core import cc                             # noqa: E402
from repro_torch.core import fluid as fluidP                 # noqa: E402
from repro_torch.kernels import fluid_reduce as FR          # noqa: E402
from test_fluid_fused import _grid                          # noqa: E402
from test_torch_fluid import _compare, _np                  # noqa: E402

SHAPES = [(1, 1, 1), (100, 3, 17), (513, 2, 5), (1536, 8, 300),
          (4096, 5, 1000)]


def _seg_inputs(n, c, s):
    rng = np.random.RandomState(n + c + s)
    seg = np.sort(rng.randint(0, s, size=n)).astype(np.int32)
    return rng.randn(n, c).astype(np.float32), seg


@pytest.mark.parametrize("n,c,s", SHAPES)
def test_segment_reduce_matches_reference_exactly(n, c, s):
    data, seg = _seg_inputs(n, c, s)
    want = np.asarray(seg_R(jnp.asarray(data), jnp.asarray(seg), s,
                            interpret=True))
    got = FR.segment_reduce(torch.from_numpy(data),
                            torch.from_numpy(seg).long(), s)
    assert np.array_equal(got.numpy(), want)


def test_segment_reduce_gathered_walk_equals_sorted_input():
    """``rows`` + ``offsets`` (the fluid step's form) = the sorted call."""
    data, seg = _seg_inputs(1536, 3, 300)
    perm = np.random.RandomState(1).permutation(1536)
    scattered = np.empty_like(data)
    scattered[perm] = data                  # row perm[j] holds entry j
    off = FR.csr_offsets(torch.from_numpy(seg).long(), 300)
    a = FR.segment_reduce(torch.from_numpy(data),
                          torch.from_numpy(seg).long(), 300)
    b = FR.segment_reduce(torch.from_numpy(scattered), None, 300,
                          rows=torch.from_numpy(perm).long(), offsets=off)
    assert torch.equal(a, b)


def test_segment_reduce_empty_input_and_segments():
    out = FR.segment_reduce(torch.zeros((0, 3)),
                            torch.zeros((0,), dtype=torch.int64), 7)
    assert torch.equal(out, torch.zeros((7, 3)))
    seg = np.asarray([3, 3, 7], np.int32)
    data = np.ones((3, 2), np.float32)
    want = np.asarray(seg_R(jnp.asarray(data), jnp.asarray(seg), 10,
                            interpret=True))
    got = FR.segment_reduce(torch.from_numpy(data),
                            torch.from_numpy(seg).long(), 10)
    assert np.array_equal(got.numpy(), want)
    assert want[3, 0] == 2.0 and not want[[0, 1, 2, 4, 5, 6, 8, 9]].any()


def test_segment_reduce_refuses_other_devices():
    with pytest.raises(ValueError, match="no kernel or plain version"):
        FR.segment_reduce(torch.ones((4, 2), device="meta"),
                          torch.zeros((4,), dtype=torch.int64,
                                      device="meta"), 3,
                          offsets=torch.zeros((4,), dtype=torch.int64,
                                              device="meta"))


def _paper_grid(R_or_P):
    """3 schemes x the paper's incast, traffic from step 20."""
    spec = R_or_P.ScenarioSpec.paper_incast(roll=0, t_start=0.02e-3)
    return R_or_P.Sweep.grid(
        configs={s.name: R_or_P.PAPER_CONFIG.replace(scheme=s)
                 for s in R_or_P.CCScheme},
        scenarios={"paper": spec})


def _stepwise_engines(sweep_R, n_steps):
    """Reference pallas steps vs the port's pallas and dense_rows=0
    steps from identical state; the two port engines also bitwise."""
    static, (st, sd, par), _, _ = sweep_R._prepare(n_steps, reduce="pallas")
    _, _, dt, n_sw, _, _, _, _, n_vcs, _, _ = static
    ref_step = jax.jit(jax.vmap(lambda s, d, p: fluidR.fluid_step(
        s, d, p, dt=dt, n_switches=n_sw, reduce="pallas", interpret=True,
        n_vcs=n_vcs)))
    sd_p = convert.scenario_dev_from_numpy(_np(sd), device="cpu")
    par_p = convert.step_params_from_numpy(_np(par), device="cpu")
    plan = fluidP.reduce_plan(sd_p, n_switches=n_sw, n_vcs=n_vcs,
                              dense_rows=0, dt=dt)
    packed = cc.pack_react_rows(par_p.react, par_p.line_rate, plan.dt)
    marks = 0
    for t in range(n_steps):
        nxt, tr = ref_step(st, sd, par)
        mine = convert.state_from_numpy(_np(st), device="cpu")
        outs = [fluidP._step_body(mine, sd_p, par_p, plan, n_switches=n_sw,
                                  reduce=red, n_vcs=n_vcs,
                                  packed_react=packed)
                for red in ("pallas", "fused")]
        (a, ta), (b, tb) = outs
        _compare(_np(nxt), tr, convert.state_to_numpy(a), ta, ("step", t))
        for x, y in zip(ta, tb):
            assert torch.equal(x, y), t
        for x, y in zip(convert.state_to_numpy(a)[:-2],
                        convert.state_to_numpy(b)[:-2]):
            assert np.array_equal(x, y), t
        marks += int(np.asarray(tr.marked).sum())
        st = nxt
    assert marks > 0


def test_pallas_and_segment_sum_steps_match_reference_on_paper_grid():
    _stepwise_engines(_paper_grid(R), 150)


def test_pallas_steps_match_reference_on_golden_grid():
    _stepwise_engines(_grid(), 30)


def test_pallas_sweep_matches_reference_at_golden_tolerance():
    import repro_torch.core as P
    n = 600
    want = _paper_grid(R).run(n_steps=n, reduce="pallas",
                              interpret=True).summary()
    got = _paper_grid(P).run(n_steps=n, reduce="pallas",
                             device="cpu").summary()
    fused = _paper_grid(P).run(n_steps=n, device="cpu").summary()
    np.testing.assert_equal(got, fused)     # nan-aware, exact
    for name, row in got.items():
        for k in ("aggregate_gbps", "completion_ms", "delivered_mb",
                  "peak_queue_kb"):
            g, w = row[k], want[name][k]
            if np.isnan(w):
                assert np.isnan(g), (name, k)
            else:
                np.testing.assert_allclose(g, w, rtol=2e-3, atol=1e-9)
        for k in ("marks", "cnps"):
            assert abs(row[k] - want[name][k]) <= max(2, 0.02 * want[name][k])


@pytest.mark.cuda
def test_segment_reduce_kernel_on_cuda():
    """On a card: the kernel bitwise equal to its plain version, counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    dev = torch.device("cuda", torch.cuda.current_device())
    FR.reset_launch_counts()
    for n, c, s in SHAPES:
        data, seg = _seg_inputs(n, c, s)
        x = torch.from_numpy(data).to(dev)
        ids = torch.from_numpy(seg).long().to(dev)
        assert torch.equal(FR.segment_reduce(x, ids, s),
                           FR.segment_reduce_plain(x, FR.csr_offsets(ids, s)))
    assert FR.LAUNCHES["segment_reduce"] == len(SHAPES)
