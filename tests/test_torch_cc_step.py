"""The port's per-flow CC kernels (``repro_torch.kernels.cc_step``) held
to the reference's Pallas kernels and oracles.

On the CPU each wrapper runs its plain PyTorch version; these tests give
it and the reference the same numpy inputs:

  * against the eager ``repro.kernels.ref`` oracles: bitwise equal (both
    round after every operation);
  * against ``repro.kernels.cc_step.*(interpret=True)``: continuous
    fields within 1 ulp.  Tolerance reason: XLA contracts ``a*b + c``
    into one fused multiply-add inside the kernel body (``alpha`` and
    ``byte_cnt`` in RP, ``rate + slope*dt`` in ERP, ``rate + ai*dt`` in
    swift) and the port rounds the product first.  Discrete fields (the
    RP stage counters) are exact, except for flows whose gate input
    ``byte_cnt + rate*dt`` lies within that 1 ulp of ``byte_B``: those
    are counted, and must be few.

The CUDA kernels themselves run only on a card: ``test_kernels_match_
plain_on_cuda`` holds them bitwise to the plain versions there and skips
elsewhere (``chip_smoke.py`` does the same on every chip run).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)      # tiny tensors: threads only add overhead

import jax.numpy as jnp                                     # noqa: E402

from repro.kernels import cc_step as KR                     # noqa: E402
from repro.kernels import ref as RR                         # noqa: E402
from repro_torch.kernels import cc_step as KP               # noqa: E402
from repro_torch.kernels import ref as RP                   # noqa: E402

SIZES = (1, 127, 129, 8193)
RP_P = dict(g=1 / 256, rate_decrease=0.5, timer_T=55e-6, byte_B=10e6,
            rai=5e6, rhai=25e6, fr_stages=5.0, min_rate=1e6,
            line_rate=12.5e9, dt=1e-6)
ERP_P = dict(settle=0.98, hold=50e-6, min_rate=1e6, line_rate=12.5e9,
             dt=1e-6)
SWIFT_P = dict(target=3e-6, beta=0.8, ai=1e12, guard=25e-6, min_rate=1e6,
               line_rate=12.5e9, dt=1e-6)


def _f32(x):
    return np.asarray(x, np.float32)


def _ulps(a, b) -> np.ndarray:
    """|a - b| in units of the float32 spacing at max(|a|, |b|)."""
    a, b = _f32(a), _f32(b)
    sp = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    return np.abs(a.astype(np.float64) - b) / sp


def _jp(p: dict):
    return {k: jnp.float32(v) for k, v in p.items()}


def _rp_inputs(F, seed):
    rng = np.random.RandomState(seed)
    st = [rng.uniform(1e6, 12.5e9, F), rng.uniform(1e6, 12.5e9, F),
          rng.uniform(0, 1, F), rng.uniform(0, 1.2e7, F),
          rng.uniform(0, 6e-5, F), rng.uniform(0, 6e-5, F),
          rng.randint(0, 9, F), rng.randint(0, 9, F)]
    return [_f32(x) for x in st], _f32(rng.rand(F) < 0.3)


def _gen_inputs(F, seed):
    rng = np.random.RandomState(seed)
    vol = np.where(rng.rand(F) < 0.5, np.inf, rng.uniform(0, 6e7, F))
    return [_f32(x) for x in (
        rng.uniform(0, 4e6, F), rng.uniform(0, 5e7, F),
        rng.uniform(0, 1e6, F), rng.uniform(0, 1e-4, F),
        rng.uniform(0, 12.5e9, F), rng.uniform(0, 2e-3, F),
        rng.uniform(1e-3, 4e-3, F), vol, rng.uniform(1e6, 4e6, F))]


def _erp_inputs(F, seed):
    rng = np.random.RandomState(seed)
    return [_f32(x) for x in (
        rng.uniform(1e6, 12.5e9, F),
        rng.uniform(0, 6e-5, F) * (rng.rand(F) < 0.5), rng.rand(F) < 0.3,
        rng.uniform(1e6, 12.5e9, F), rng.uniform(2.5e12, 7.5e12, F))]


def _swift_inputs(F, seed):
    rng = np.random.RandomState(seed)
    return [_f32(x) for x in (
        rng.uniform(1e6, 12.5e9, F),
        rng.uniform(0, 5e-5, F) * (rng.rand(F) < 0.5),
        rng.uniform(0, 1e-5, F))]


def _t(xs):
    return [torch.from_numpy(x.copy()) for x in xs]


@pytest.mark.parametrize("F", SIZES)
def test_rp_matches_reference(F):
    st, cnp = _rp_inputs(F, seed=F)
    got = KP.rp_step(RP.RPState(*_t(st)), torch.from_numpy(cnp),
                     RP.RPParams(**RP_P))
    got = [x.numpy() for x in got]
    jst = RR.RPState(*map(jnp.asarray, st))
    oracle = RR.rp_update_ref(jst, jnp.asarray(cnp) > 0,
                              RR.RPParams(**_jp(RP_P)))
    for name, a, b in zip(RR.RPState._fields, oracle, got):
        assert np.array_equal(np.asarray(a), b), ("oracle", name)
    kern = KR.rp_step(jst, jnp.asarray(cnp), RR.RPParams(**_jp(RP_P)),
                      interpret=True)
    # flows whose byte-counter gate input sits within 1 ulp of byte_B
    pre = st[3].astype(np.float64) + st[0].astype(np.float64) * 1e-6
    near = (cnp == 0) & (np.abs(pre - RP_P["byte_B"])
                         <= np.spacing(np.float32(RP_P["byte_B"])))
    assert near.sum() <= max(1, F // 1000), near.sum()
    for name, a, b in zip(RR.RPState._fields, kern, got):
        a = np.asarray(a)
        if name in ("bc_stage", "t_stage"):
            assert np.array_equal(a[~near], b[~near]), name
        else:
            assert _ulps(a, b)[~near].max(initial=0) <= 1.0, name


@pytest.mark.parametrize("F", SIZES)
def test_gen_np_matches_reference(F):
    xs = _gen_inputs(F, seed=F)
    for t_sec in (0.5e-3, 1.5e-3, 3.5e-3):
        kern = KR.gen_np_step(*map(jnp.asarray, xs), t_sec=jnp.float32(t_sec),
                              dt=jnp.float32(1e-6), interpret=True)
        got = KP.gen_np_step(*_t(xs), t_sec=torch.tensor(t_sec),
                             dt=torch.tensor(1e-6))
        for i, (a, b) in enumerate(zip(kern, got)):
            assert _ulps(a, b.numpy()).max(initial=0) <= 1.0, (t_sec, i)


@pytest.mark.parametrize("F", SIZES)
def test_erp_matches_reference(F):
    xs = _erp_inputs(F, seed=F)
    got = [x.numpy() for x in KP.erp_step(*_t(xs), RP.ERPParams(**ERP_P))]
    j = list(map(jnp.asarray, xs))
    oracle = RR.erp_update_ref(j[0], j[1], j[2] > 0, j[3], j[4],
                               RR.ERPParams(**_jp(ERP_P)))
    for a, b in zip(oracle, got):
        assert np.array_equal(np.asarray(a), b)
    kern = KR.erp_step(*j, RR.ERPParams(**_jp(ERP_P)), interpret=True)
    assert _ulps(kern[0], got[0]).max(initial=0) <= 1.0
    assert np.array_equal(np.asarray(kern[1]), got[1])


@pytest.mark.parametrize("F", SIZES)
def test_swift_matches_reference(F):
    xs = _swift_inputs(F, seed=F)
    got = [x.numpy() for x in KP.swift_step(*_t(xs),
                                           RP.SwiftKParams(**SWIFT_P))]
    j = list(map(jnp.asarray, xs))
    oracle = RR.swift_update_ref(*j, **_jp(SWIFT_P))
    for a, b in zip(oracle, got):
        assert np.array_equal(np.asarray(a), b)
    kern = KR.swift_step(*j, RR.SwiftKParams(**_jp(SWIFT_P)), interpret=True)
    assert _ulps(kern[0], got[0]).max(initial=0) <= 1.0
    assert np.array_equal(np.asarray(kern[1]), got[1])


def test_torch_oracles_match_reference_oracles():
    """``repro_torch.kernels.ref`` is the reference's oracle, bitwise."""
    st, cnp = _rp_inputs(513, seed=3)
    a = RR.rp_update_ref(RR.RPState(*map(jnp.asarray, st)),
                         jnp.asarray(cnp) > 0, RR.RPParams(**_jp(RP_P)))
    b = RP.rp_update_ref(RP.RPState(*_t(st)), torch.from_numpy(cnp) > 0,
                         RP.RPParams(**RP_P))
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), y.numpy())
    xs = _erp_inputs(513, seed=4)
    j, t = list(map(jnp.asarray, xs)), _t(xs)
    a = RR.erp_update_ref(j[0], j[1], j[2] > 0, j[3], j[4],
                          RR.ERPParams(**_jp(ERP_P)))
    b = RP.erp_update_ref(t[0], t[1], t[2] > 0, t[3], t[4],
                          RP.ERPParams(**ERP_P))
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), y.numpy())
    xs = _swift_inputs(513, seed=5)
    a = RR.swift_update_ref(*map(jnp.asarray, xs), **_jp(SWIFT_P))
    b = RP.swift_update_ref(*_t(xs), **SWIFT_P)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), y.numpy())


def test_per_run_rows_match_run_by_run():
    """A [R, F] batch with one parameter row per run equals R separate
    single-row calls — the run indexing every kernel launch relies on."""
    R, F = 4, 129
    st, cnp = _rp_inputs(R * F, seed=11)
    st = [x.reshape(R, F) for x in st]
    cnp = cnp.reshape(R, F)
    ps = [dict(RP_P, g=1 / (64 * (r + 1)), rai=5e6 * (r + 1))
          for r in range(R)]
    rows = torch.cat([KP.pack_rp_params(RP.RPParams(**p)) for p in ps])
    batch = KP.rp_step(RP.RPState(*_t(st)), torch.from_numpy(cnp),
                       packed=rows)
    for r in range(R):
        one = KP.rp_step(RP.RPState(*_t([x[r] for x in st])),
                         torch.from_numpy(cnp[r].copy()),
                         RP.RPParams(**ps[r]))
        for a, b in zip(batch, one):
            assert torch.equal(a[r], b)


def test_cpu_runs_plain_version_and_counts_no_launch():
    KP.reset_launch_counts()
    xs = _swift_inputs(64, seed=1)
    KP.swift_step(*_t(xs), RP.SwiftKParams(**SWIFT_P))
    st, cnp = _rp_inputs(64, seed=1)
    KP.rp_step(RP.RPState(*_t(st)), torch.from_numpy(cnp),
               RP.RPParams(**RP_P))
    assert set(KP.LAUNCHES.values()) == {0}


def test_wrappers_validate_inputs():
    xs = _t(_swift_inputs(64, seed=2))
    p = RP.SwiftKParams(**SWIFT_P)
    with pytest.raises(TypeError, match="float32"):
        KP.swift_step(xs[0].double(), xs[1], xs[2], p)
    with pytest.raises(ValueError, match="shapes differ"):
        KP.swift_step(xs[0][:10], xs[1], xs[2], p)
    with pytest.raises(ValueError, match="contiguous"):
        wide = torch.zeros(64, 2)
        KP.swift_step(wide[:, 0], xs[1], xs[2], p)
    with pytest.raises(ValueError, match="parameter rows"):
        KP.swift_step(xs[0], xs[1], xs[2],
                      packed=torch.zeros(3, 7, dtype=torch.float32))
    with pytest.raises(ValueError, match="no kernel"):
        KP.swift_step(*[x.to("meta") for x in xs], p)


@pytest.mark.cuda
def test_kernels_match_plain_on_cuda():
    """On a card: each CUDA kernel bitwise equal to its plain version
    on the same device tensors, and counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    dev = torch.device("cuda", torch.cuda.current_device())
    KP.reset_launch_counts()
    for F in SIZES:
        xs = [x.to(dev) for x in _t(_swift_inputs(F, seed=F))]
        rows = KP.pack_swift_params(RP.SwiftKParams(**SWIFT_P)).to(dev)
        for a, b in zip(KP.swift_step(*xs, packed=rows),
                        KP.swift_plain(*xs, rows)):
            assert torch.equal(a, b)
        xs = [x.to(dev) for x in _t(_erp_inputs(F, seed=F))]
        rows = KP.pack_erp_params(RP.ERPParams(**ERP_P)).to(dev)
        for a, b in zip(KP.erp_step(*xs, packed=rows),
                        KP.erp_plain(*xs, rows)):
            assert torch.equal(a, b)
        st, cnp = _rp_inputs(F, seed=F)
        st = RP.RPState(*[x.to(dev) for x in _t(st)])
        cnp = torch.from_numpy(cnp).to(dev)
        rows = KP.pack_rp_params(RP.RPParams(**RP_P)).to(dev)
        for a, b in zip(KP.rp_step(st, cnp, packed=rows),
                        KP.rp_plain(st, cnp, rows)):
            assert torch.equal(a, b)
        xs = [x.to(dev) for x in _t(_gen_inputs(F, seed=F))]
        t_sec = torch.tensor(1.5e-3, device=dev)
        dt = torch.tensor(1e-6, device=dev)
        for a, b in zip(KP.gen_np_step(*xs, t_sec=t_sec, dt=dt),
                        KP.gen_np_plain(*xs, KP.pack_gen_np_params(t_sec, dt))):
            assert torch.equal(a, b)
    # swift takes four flows a thread with 16-byte loads: every residue
    # of n mod 4, runs that end inside a thread, and views 4 bytes past
    # a 16-byte boundary (its scalar path)
    rows = torch.cat([KP.pack_swift_params(RP.SwiftKParams(
        **dict(SWIFT_P, target=SWIFT_P["target"] * (r + 1))))
        for r in range(3)]).to(dev)
    n_swift = 0
    for R, F in [(1, 4097), (1, 4098), (1, 4099), (3, 1), (3, 2), (3, 1365)]:
        for shift in (0, 1):
            xs = []
            for x in _t(_swift_inputs(R * F, seed=F)):
                buf = torch.zeros(R * F + shift, device=dev)
                buf[shift:] = x.to(dev)
                xs.append(buf[shift:].view(R, F))
            assert xs[0].data_ptr() % 16 == 4 * shift
            r = rows[:R] if R > 1 else rows[:1]
            for a, b in zip(KP.swift_step(*xs, packed=r),
                            KP.swift_plain(*xs, r)):
                assert torch.equal(a, b), (R, F, shift)
            n_swift += 1
    torch.cuda.synchronize()
    want = {k: len(SIZES) for k in KP.LAUNCHES}
    want["swift_step"] += n_swift
    assert KP.LAUNCHES == want
