"""The CUDA-core route of ``flash_attention`` (``csrc/flash_attention.cu``,
anonymous namespace) modelled on the CPU, and the kernels package's
public surface against the reference's.

The kernel runs only on a card.  Here a numpy model of its walk, built
from the tile constants in its source (``Tile<DB>``, ``NT``, ``RING``),
repeats what could hide a formula error: the folded GQA rows of a CTA,
the kv tiles it skips, the tiles where masks are evaluated, logits in
log2 units (dot * scale / cap, the softcap's ``tanh``, * cap * log2 e),
``exp2`` softmax with corr frozen while m == -1e30, and acc / max(l,
1e-30).  It runs in float32 and is held to the reference's
``flash_attention`` (interpret mode, as ``tests/test_kernels.py`` runs
it) and its untiled oracle at the reference's float32 bound, 3e-5.
These tests hold the model, not the kernel: the model is tied to the
source only by the parsed constants, so a change to the kernel's
skipping or masking shows only in the ``cuda``-marked test, which runs
the kernel on a card.

Also: the kernel's shared memory at every head-dim bucket fits the card,
and ``repro_torch.kernels`` / ``ops`` / ``core.run_all_schemes`` match
the reference's names and results.
"""

import importlib
import os
import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)      # tiny tensors: threads only add overhead

import jax.numpy as jnp                                     # noqa: E402

import repro.kernels as kernels_R                           # noqa: E402
from repro.kernels import ops as ops_R                      # noqa: E402
from repro.kernels import ref as ref_R                      # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as flash_R                              # noqa: E402
import repro_torch.kernels as kernels_P                     # noqa: E402
from repro_torch.kernels import ops as ops_P                # noqa: E402
from test_kernels import FLASH_CASES                        # noqa: E402
from test_torch_cc_step import (ERP_P, RP_P, _erp_inputs,   # noqa: E402
                                _jp, _rp_inputs, _t)

FA = importlib.import_module("repro_torch.kernels.flash_attention")
F32 = dict(atol=3e-5, rtol=3e-5)
#: the card's shared memory a block may use (H100, opt-in maximum)
SMEM_LIMIT = 232_448
BUCKETS = (16, 32, 64, 128, 256)


def _source() -> str:
    path = os.path.join(os.path.dirname(FA.__file__), "..", "csrc",
                        "flash_attention.cu")
    with open(path) as f:
        text = f.read()
    return text[:text.index("namespace tc {")]   # the CUDA-core route


def _geometry(db: int) -> dict:
    """The bucket's tile shape from the source: TR, TK, TC, KG as written
    in ``Tile<db>``, and BR, BK, the padded strides and the dynamic
    shared memory in bytes as ``Geo<db>`` derives them."""
    text = _source()
    nt = int(re.search(r"constexpr int NT = (\d+);", text).group(1))
    ring = int(re.search(r"constexpr int RING = (\d+);", text).group(1))
    m = re.search(r"struct Tile<%d> \{\s*static constexpr int TR = (\d+), "
                  r"TK = (\d+), TC = (\d+), KG = (\d+);" % db, text)
    tr, tk, tc, kg = map(int, m.groups())
    pad_q, pad_p = map(int, re.search(
        r"QS\s*=\s*DB\s*\+\s*(\d+),\s*PS\s*=\s*BK\s*\+\s*(\d+)",
        text).groups())
    br, bk = nt // kg * tr, kg * tk
    qs, ps = db + pad_q, bk + pad_p
    return dict(NT=nt, RING=ring, TR=tr, TK=tk, TC=tc, KG=kg, BR=br, BK=bk,
                QS=qs, PS=ps,
                smem=4 * (br * qs + ring * bk * qs + br * ps))


def _bucket(d: int) -> int:
    return next(db for db in BUCKETS if d <= db)


# ---------------------------------------------------------------------------
# the kernel's walk, modelled
# ---------------------------------------------------------------------------

LOG2E = np.float32(1.4426950408889634)
NEG = np.float32(-1e30)


def _flash_model(q, k, v, *, causal, window, softcap, scale):
    """numpy float32 model of ``flash_kernel``: CTAs of BR folded rows
    (R = pos * g + group) of one (batch, kv head), kv tiles [jlo, jhi)
    of BK keys, masks only in tiles that are not ``full``."""
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    geo = _geometry(_bucket(d))
    BR, BK = geo["BR"], geo["BK"]
    f32 = np.float32
    scale = f32(scale if scale is not None else 1.0 / np.sqrt(d))
    if softcap > 0:
        qk_mul, cap2 = scale / f32(softcap), f32(softcap) * LOG2E
    else:
        qk_mul, cap2 = scale * LOG2E, f32(0.0)
    nrows = t * g
    # rows position-major: [b, kv, t * g, d]
    qf = q.reshape(b, t, kv, g, d).transpose(0, 2, 1, 3, 4)
    qf = qf.reshape(b, kv, nrows, d)
    kf, vf = k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3)
    out = np.zeros((b, kv, nrows, d), f32)
    ntiles = -(-s // BK)
    for r0 in range(0, nrows, BR):
        rows = np.arange(r0, min(r0 + BR, nrows))
        qpos = rows // g
        qfirst, qlast = r0 // g, (rows[-1]) // g
        jhi = min(ntiles, qlast // BK + 1) if causal else ntiles
        jlo = 0
        if window is not None and qfirst - window - BK + 1 >= 0:
            jlo = (qfirst - window - BK + 1) // BK + 1
        m = np.full((b, kv, len(rows)), NEG, f32)
        l = np.zeros((b, kv, len(rows)), f32)
        acc = np.zeros((b, kv, len(rows), d), f32)
        for j in range(jlo, jhi):
            k0 = j * BK
            keys = np.arange(k0, min(k0 + BK, s))
            x = (qf[:, :, rows] @ kf[:, :, keys].transpose(0, 1, 3, 2))
            x = x.astype(f32) * qk_mul
            if softcap > 0:
                x = np.tanh(x) * cap2
            full = (k0 + BK <= s and (not causal or k0 + BK - 1 <= qfirst)
                    and (window is None or k0 > qlast - window))
            ok = np.ones((len(rows), len(keys)), bool)
            if not full:
                if causal:
                    ok &= keys[None, :] <= qpos[:, None]
                if window is not None:
                    ok &= keys[None, :] > qpos[:, None] - window
            x = np.where(ok, x, NEG).astype(f32)
            m_new = np.maximum(m, x.max(-1))
            corr = np.where(m == NEG, f32(1.0),
                            np.exp2(m - m_new)).astype(f32)
            p = np.where(ok, np.exp2(x - m_new[..., None]), 0.0).astype(f32)
            l = (l * corr + p.sum(-1)).astype(f32)
            acc = (acc * corr[..., None]
                   + p @ vf[:, :, keys]).astype(f32)
            m = m_new
        out[:, :, rows] = acc / np.maximum(l, f32(1e-30))[..., None]
    out = out.reshape(b, kv, t, g, d).transpose(0, 2, 1, 3, 4)
    return out.reshape(b, t, h, d)


def _inputs(seed, b, t, s, h, kv, d, qk_sd):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, t, h, d).astype(np.float32) * qk_sd,
            rng.randn(b, s, kv, d).astype(np.float32) * qk_sd,
            rng.randn(b, s, kv, d).astype(np.float32))


#: (b, t, h, kv, d, causal, window, cap): the head dims the route takes
#: at each cap, q/k at 2x unit scale where a cap is set so that it bites;
#: t = 300 crosses two CTAs of every bucket, and the window of 64 skips
#: whole tiles behind the later CTAs
MODEL_DIMS = [(2, 300, 4, 2, d, True, 64 if d in (8, 100) else None, cap)
              for d in (1, 8, 16, 32, 100, 256)
              for cap in (0.0, 2.0, 5.0, 50.0)]


@pytest.mark.parametrize("b,t,h,kv,d,causal,window,cap,bq,bk", FLASH_CASES)
def test_walk_model_matches_reference_kernel(b, t, h, kv, d, causal,
                                             window, cap, bq, bk):
    """Every FLASH_CASES shape, against the reference's kernel in
    interpret mode and its oracle."""
    q, k, v = _inputs(t * h + d, b, t, t, h, kv, d, 0.3)
    got = _flash_model(q, k, v, causal=causal, window=window, softcap=cap,
                       scale=None)
    j = [jnp.asarray(x) for x in (q, k, v)]
    kern = flash_R(*j, causal=causal, window=window, softcap=cap,
                   block_q=bq, block_k=bk, interpret=True)
    want = ref_R.attention_ref(*j, causal=causal, window=window,
                               softcap=cap)
    np.testing.assert_allclose(got, np.asarray(kern), **F32)
    np.testing.assert_allclose(got, np.asarray(want), **F32)


@pytest.mark.parametrize("b,t,h,kv,d,causal,window,cap", MODEL_DIMS)
def test_walk_model_matches_reference_at_every_bucket(b, t, h, kv, d, causal,
                                                      window, cap):
    """d 1-256 (every bucket, ragged widths zero-padded) at caps 0, 2, 5
    and 50 against the reference's oracle; where the cap is set, dropping
    it leaves the bound, so the model's softcap is what is checked."""
    q, k, v = _inputs(d * 7 + int(cap), b, t, t, h, kv, d,
                      2.0 if cap else 0.3)
    kw = dict(causal=causal, window=window)
    got = _flash_model(q, k, v, softcap=cap, scale=None, **kw)
    j = [jnp.asarray(x) for x in (q, k, v)]
    want = np.asarray(ref_R.attention_ref(*j, softcap=cap, **kw))
    np.testing.assert_allclose(got, want, **F32)
    if cap and d > 1:
        nocap = np.asarray(ref_R.attention_ref(*j, **kw))
        assert not np.allclose(nocap, want, **F32)


def test_walk_model_skips_every_tile_of_a_block_behind_the_window():
    """t > s under a window: rows past s + window - 1 see no key; the
    kernel (like the reference's) skips every tile there and writes 0."""
    b, t, s, h, kv, d, window = 1, 512, 64, 4, 2, 32, 16
    q, k, v = _inputs(3, b, t, s, h, kv, d, 0.3)
    got = _flash_model(q, k, v, causal=True, window=window, softcap=0.0,
                       scale=None)
    kern = np.asarray(flash_R(*[jnp.asarray(x) for x in (q, k, v)],
                              window=window, block_q=64, block_k=64,
                              interpret=True))
    seen = s + window - 1
    np.testing.assert_allclose(got[:, :seen], kern[:, :seen], **F32)
    assert not got[:, seen:].any() and not kern[:, seen:].any()


# ---------------------------------------------------------------------------
# the kernel's resources
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("db", BUCKETS)
def test_cuda_core_shared_memory_fits_the_card(db):
    """Q, the RING K/V slots and P at each bucket fit the 232,448 B a
    block may use, with 8 warps a block; rows are padded to an odd
    count of 16-byte chunks (distinct banks for consecutive rows) and
    the tile shape covers the bucket, S and O from the same rows."""
    geo = _geometry(db)
    assert geo["smem"] <= SMEM_LIMIT, (db, geo)
    assert geo["NT"] // 32 >= 8 and geo["RING"] >= 3
    assert geo["KG"] * geo["TC"] == db and geo["TC"] % 4 == 0
    assert (geo["NT"] // geo["KG"]) * geo["KG"] == geo["NT"]
    assert 32 % geo["KG"] == 0                  # a row's lanes in one warp
    for stride in (geo["QS"], geo["PS"]):
        assert stride % 4 == 0 and (stride // 4) % 2 == 1, (db, stride)
    # every thread holds TR x TK of S and TR x TC of O in registers
    assert geo["TR"] * (geo["TK"] + geo["TC"]) <= 96


def test_buckets_cover_every_head_dim_the_route_takes():
    assert BUCKETS[-1] == FA.MAX_HEAD_DIM
    text = _source()
    for db in BUCKETS:
        assert f"launch<T, {db}>" in text


# ---------------------------------------------------------------------------
# repro_torch.kernels: the reference's public surface
# ---------------------------------------------------------------------------

def test_kernels_all_is_the_references():
    assert kernels_P.__all__ == kernels_R.__all__


@pytest.mark.parametrize("name", kernels_R.__all__)
def test_kernels_binds_the_same_kind_of_object(name):
    """Each name is a module where the reference's is one (ops, ref) and
    otherwise the function of that name."""
    want, got = getattr(kernels_R, name), getattr(kernels_P, name)
    if isinstance(want, types.ModuleType):
        assert isinstance(got, types.ModuleType)
        assert got.__name__ == "repro_torch.kernels." + name
    else:
        assert callable(got) and not isinstance(got, types.ModuleType)
        assert got.__name__ == want.__name__ == name


def test_ops_cc_rp_update_matches_reference():
    st, cnp = _rp_inputs(513, seed=21)
    from repro.kernels.ref import RPParams as RPParams_R, RPState as RPS_R
    from repro_torch.kernels.ref import RPParams, RPState
    got = ops_P.cc_rp_update(RPState(*_t(st)), torch.from_numpy(cnp),
                             RPParams(**RP_P))
    want = ops_R.cc_rp_update(RPS_R(*map(jnp.asarray, st)),
                              jnp.asarray(cnp) > 0, RPParams_R(**_jp(RP_P)),
                              backend="ref")
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_ops_cc_erp_update_matches_reference():
    xs = _erp_inputs(513, seed=22)
    from repro.kernels.ref import ERPParams as ERPParams_R
    from repro_torch.kernels.ref import ERPParams
    got = ops_P.cc_erp_update(*_t(xs), ERPParams(**ERP_P))
    j = list(map(jnp.asarray, xs))
    want = ops_R.cc_erp_update(j[0], j[1], j[2] > 0, j[3], j[4],
                               ERPParams_R(**_jp(ERP_P)), backend="ref")
    for a, b in zip(want, got):
        assert np.array_equal(np.asarray(a), b.numpy())


# ---------------------------------------------------------------------------
# core.run_all_schemes
# ---------------------------------------------------------------------------

RUN_STEPS = 600
SCHEMES = ("PFC_ONLY", "DCQCN", "DCQCN_REV")


@pytest.fixture(scope="module")
def scheme_runs():
    """``run_all_schemes`` on a 4-to-1 incast with a victim on the paper's
    CLOS (flows open at 0), port and reference, and the port's own
    3-point Sweep of the same points."""
    from repro.core import PAPER_CONFIG as CFG_R
    from repro.core import run_all_schemes as ras_R
    from repro.core.scenarios import incast as incast_R
    from repro_torch.core import PAPER_CONFIG, CCScheme, Sweep, incast
    from repro_torch.core import run_all_schemes
    kw = dict(t_start=0.0, t_stop=2e-3)
    scn = incast(PAPER_CONFIG, 4, **kw)
    port = run_all_schemes(scn, PAPER_CONFIG, RUN_STEPS, device="cpu")
    pts = [(s, PAPER_CONFIG.replace(scheme=CCScheme[s]), scn)
           for s in SCHEMES]
    own = Sweep(pts).run(n_steps=RUN_STEPS, device="cpu")
    ref = ras_R(incast_R(CFG_R, 4, **kw), CFG_R, RUN_STEPS)
    return port, own, ref


@pytest.mark.parametrize("scheme", SCHEMES)
def test_run_all_schemes_is_the_sweep_and_the_reference(scheme_runs,
                                                         scheme):
    """Bitwise the port's own Sweep of the same point; within the golden
    tolerances (floats rtol 2e-3, counters 2% or 2) of the reference."""
    port, own, ref = scheme_runs
    assert list(port) == list(SCHEMES) == list(ref)
    a, b = port[scheme], own[scheme]
    for key in ("times", "delivered", "rate", "inst_thr", "max_q",
                "n_paused", "marked", "cnp"):
        assert np.array_equal(getattr(a, key), getattr(b, key),
                              equal_nan=True), key
    got, want = a.summary(), ref[scheme].summary()
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        if isinstance(w, (list, tuple)):
            np.testing.assert_allclose(g, w, rtol=2e-3, atol=1e-9,
                                       err_msg=key)
        elif key in ("marks", "cnps", "peak_nonmin_flows"):
            assert abs(g - w) <= max(2, 0.02 * w), (key, g, w)
        elif isinstance(w, float) and np.isnan(w):
            assert np.isnan(g), key
        else:
            np.testing.assert_allclose(g, w, rtol=2e-3, atol=1e-9,
                                       err_msg=key)


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_core_route_at_every_bucket_on_cuda():
    """The kernel against its plain version (run in float32 on the same
    values) at MODEL_DIMS in both dtypes: 3e-5 in float32, 2e-2 in
    bfloat16 (at d 256, which ``_route`` sends to the tensor cores, the
    CUDA-core kernel launched by name); every launch on the CUDA-core
    route, two launches bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    dev = torch.device("cuda", torch.cuda.current_device())
    FA.reset_launch_counts()
    n = 0
    for b, t, h, kv, d, causal, window, cap in MODEL_DIMS:
        for dtype, tol in ((torch.float32, 3e-5), (torch.bfloat16, 2e-2)):
            q, k, v = [torch.from_numpy(x).to(dev, dtype) for x in _inputs(
                d + int(cap), b, t, t, h, kv, d, 2.0 if cap else 0.3)]
            kw = dict(causal=causal, window=window, softcap=cap)
            # bf16 at d 256 routes to the tensor cores: the CUDA-core
            # kernel is launched by name there
            run = (lambda: FA.flash_attention(q, k, v, **kw)) \
                if FA._route(dtype, d) == "cuda_core" else \
                (lambda: FA._launch("cuda_core", q, k, v, scale=None, **kw))
            got = run()
            want = FA.flash_attention_plain(q.float(), k.float(), v.float(),
                                            **kw)
            torch.cuda.synchronize()
            np.testing.assert_allclose(got.float().cpu().numpy(),
                                       want.cpu().numpy(), atol=tol,
                                       rtol=tol)
            assert torch.equal(got, run())
            n += 2
    assert FA.ROUTES == {"tensor_core": 0, "cuda_core": n}
    assert FA.LAUNCHES["flash_attention"] == n
