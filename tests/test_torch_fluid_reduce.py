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

The card's work list, ``reduce_schedule``, is checked here on the CSRs
the kernel walks (the hotspot's 2055-row queue, a dc-like permutation,
empty, single and skewed CSRs): every segment in exactly one item, each
in the right bucket, groups within the kernel's shared-memory chunk.

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


def _skewed_offsets(long_rows=2055, n_short=3000, seed=0):
    """One ``long_rows``-row segment among ``n_short`` short ones (0-40
    rows, some empty): the hotspot's queue beside ordinary ones."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(0, 41, size=n_short + 1)
    lens[n_short // 3] = long_rows
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)


def _hotspot_plan():
    """The hotspot cell's batch (3 schemes x hotspot(4096, 272) on
    dragonfly(4, 4, 4), flows open at 20 us), prepared on the CPU."""
    import repro_torch.core as P
    from repro_torch.core.workloads import hotspot
    from repro_torch.net import FabricSpec
    spec = hotspot(4096, 272, t_start=20e-6).spec(
        fabric=FabricSpec.dragonfly(4, 4, 4))
    sweep = P.Sweep.grid(configs={s.name: P.PAPER_CONFIG.replace(scheme=s)
                                  for s in P.CCScheme},
                         scenarios={"hot4096": spec})
    return sweep.prepare(1, device="cpu").plan


def _dc_offsets():
    """One run of the dc cell's CSR: permutation(4096) on the 272-host
    dragonfly."""
    import repro_torch.core as P
    from repro_torch.net import FabricSpec
    spec = P.ScenarioSpec.permutation(4096, seed=0,
                                      fabric=FabricSpec.dragonfly(4, 4, 4))
    sweep = P.Sweep.grid(configs={"dcqcn": P.PAPER_CONFIG},
                         scenarios={"dc": spec})
    return sweep.prepare(1, device="cpu").plan.seg_off.numpy()


CSRS = {
    "hotspot": lambda: _hotspot_plan().seg_off.numpy(),
    "dc": _dc_offsets,
    "empty_segments": lambda: np.zeros(9, np.int64),
    "N0": lambda: np.zeros(1, np.int64),
    "single": lambda: np.asarray([0, 5000], np.int64),
    "skewed": _skewed_offsets,
    "all_long": lambda: np.arange(0, 6 * 300, 300, dtype=np.int64),
    "tiny_many": lambda: np.arange(0, 1001, dtype=np.int64) // 3,
}


@pytest.mark.parametrize("name", sorted(CSRS))
def test_schedule_partitions_every_segment_once(name):
    """``reduce_schedule``: the long segments (more than LONG_ROWS rows)
    first, one item each, in order; then groups of consecutive short
    segments of at most CHUNK_ROWS rows and GROUP_SEGS segments; every
    segment in exactly one item, each item with its walk range, and each
    group's lanes a permutation of its segments, longest first."""
    off = CSRS[name]()
    lens = np.diff(off)
    sched = FR.reduce_schedule(torch.from_numpy(off))
    items = sched.items.numpy()
    assert sched.items.dtype == torch.int32 and items.shape[1] == 4
    assert sched.lanes.dtype == torch.uint8
    assert sched.lanes.shape == (lens.size,)
    assert np.array_equal(items[:, 2:], off[items[:, :2]])
    lanes = sched.lanes.numpy().astype(np.int64)
    longs, groups = items[:sched.n_long, :2], items[sched.n_long:, :2]
    assert np.array_equal(longs[:, 0], np.flatnonzero(lens > FR.LONG_ROWS))
    assert np.array_equal(longs[:, 1], longs[:, 0] + 1)
    seen = np.zeros(lens.size, np.int64)
    for a, b in longs:
        seen[a:b] += 1
    for a, b in groups:
        assert 0 < b - a <= FR.GROUP_SEGS, (a, b)
        assert (lens[a:b] <= FR.LONG_ROWS).all(), (a, b)
        assert off[b] - off[a] <= FR.CHUNK_ROWS, (a, b)
        order = a + lanes[a:b]
        assert np.array_equal(np.sort(order), np.arange(a, b)), (a, b)
        assert (np.diff(lens[order]) <= 0).all(), (a, b)
        seen[a:b] += 1
    assert (seen == 1).all()
    if groups.size:                       # groups in segment order
        assert (groups[1:, 0] >= groups[:-1, 1]).all()
    if name == "hotspot":
        assert lens.max() == 2055 and sched.n_long == 12


def test_plan_carries_the_schedule_of_its_csr():
    """The fluid step's plan holds the schedule of its own CSR, so the
    three walks of a step share one."""
    plan = _hotspot_plan()
    want = FR.reduce_schedule(plan.seg_off)
    assert plan.seg_sched.n_long == want.n_long
    assert torch.equal(plan.seg_sched.items, want.items)
    assert torch.equal(plan.seg_sched.lanes, want.lanes)


def test_kernel_constants_match_the_source():
    """The schedule's chunk and group sizes are the kernel's shared-memory
    chunk (``kChunkRows``) and thread count (``kGroupSegs``), and a long
    segment is longer than a short group's chain phase should run."""
    import os
    import re
    path = os.path.join(os.path.dirname(FR.__file__), "..", "csrc",
                        "fluid_reduce.cu")
    text = open(path).read()
    val = lambda name: int(re.search(  # noqa: E731
        r"constexpr int " + name + r" = (\w+);", text).group(1)
        .replace("kThreads", re.search(r"constexpr int kThreads = (\d+);",
                                       text).group(1)))
    assert val("kChunkRows") == FR.CHUNK_ROWS
    assert val("kGroupSegs") == FR.GROUP_SEGS
    assert FR.LONG_ROWS <= FR.CHUNK_ROWS
    assert re.search(r"case (\d):", text) and sorted(
        int(c) for c in re.findall(r"case (\d):", text)) == list(
            FR.STAGED_CHANNELS)


@pytest.mark.parametrize("c", [1, 2, 3])
def test_skewed_csr_matches_reference_with_and_without_schedule(c):
    """One 2055-row segment among short ones: equal to the reference's
    Pallas kernel (interpret mode) with and without a passed schedule."""
    off = _skewed_offsets(n_short=400, seed=c)
    lens = np.diff(off)
    seg = np.repeat(np.arange(lens.size), lens).astype(np.int32)
    data = np.random.RandomState(c).randn(seg.size, c).astype(np.float32)
    want = np.asarray(seg_R(jnp.asarray(data), jnp.asarray(seg), lens.size,
                            interpret=True))
    x, o = torch.from_numpy(data), torch.from_numpy(off)
    for sched in (None, FR.reduce_schedule(o)):
        got = FR.segment_reduce(x, None, lens.size, offsets=o,
                                schedule=sched)
        assert np.array_equal(got.numpy(), want)


def _cuda_cases(dev):
    """(data, offsets, rows) on the card: SHAPES, the skewed CSR through a
    random gather at C = 1, 2, 3, and the hotspot's three walks."""
    for n, c, s in SHAPES:
        data, seg = _seg_inputs(n, c, s)
        ids = torch.from_numpy(seg).long().to(dev)
        yield torch.from_numpy(data).to(dev), FR.csr_offsets(ids, s), None
    off = torch.from_numpy(_skewed_offsets()).to(dev)
    n = int(off[-1])
    rows = torch.from_numpy(np.random.RandomState(3).permutation(n)).to(dev)
    for c in (1, 2, 3):
        data = np.random.RandomState(c).randn(n, c).astype(np.float32)
        yield torch.from_numpy(data).to(dev), off, rows
    plan = _hotspot_plan()
    for w, c in enumerate((3, 3, 2)):
        data = np.random.RandomState(w).randn(3 * 4096 * 5, c)
        yield (torch.from_numpy(data.astype(np.float32)).to(dev),
               plan.seg_off.to(dev), plan.seg_rows.to(dev))


@pytest.mark.cuda
def test_segment_reduce_kernel_on_cuda():
    """On a card: the kernel bitwise equal to its plain version, counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    dev = torch.device("cuda", torch.cuda.current_device())
    FR.reset_launch_counts()
    n_calls = 0
    for x, off, rows in _cuda_cases(dev):
        S = off.shape[0] - 1
        want = FR.segment_reduce_plain(x, off, rows)
        for sched in (None, FR.reduce_schedule(off)):
            got = FR.segment_reduce(x, None, S, rows=rows, offsets=off,
                                    schedule=sched)
            assert torch.equal(got, want)
            n_calls += 1
    assert FR.LAUNCHES["segment_reduce"] == n_calls
