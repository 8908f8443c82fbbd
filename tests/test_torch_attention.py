"""The port's attention kernels against the reference's.

``repro_torch.kernels.flash_attention`` / ``decode_attention`` run
their plain versions on a CPU tensor; here those are held to the
reference's Pallas kernels (interpret mode) and to its untiled oracles
(``repro.kernels.ref``) on the same inputs, made with numpy from a
seed, at the reference's own tolerances (``tests/test_kernels.py``):
atol = rtol = 3e-5 in float32, 2e-2 in bfloat16.

The CUDA kernels run only on a card: the ``cuda``-marked tests hold
each against its plain version there and skip elsewhere.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)      # tiny tensors: threads only add overhead

import jax.numpy as jnp                                     # noqa: E402

from repro.kernels import ref as ref_R                      # noqa: E402
from repro.kernels.decode_attention import \
    decode_attention as decode_R                            # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as flash_R                              # noqa: E402
from repro_torch.kernels import decode_attention as DA      # noqa: E402
from repro_torch.kernels import flash_attention as FA       # noqa: E402
from repro_torch.kernels import ops                         # noqa: E402
from test_kernels import FLASH_CASES                        # noqa: E402

#: the decode cases of tests/test_kernels.py: b, s, h, kv, d, cap, bk
DECODE_CASES = [
    (2, 256, 8, 2, 64, 0.0, 128),
    (1, 1000, 4, 1, 64, 50.0, 256),     # ragged
    (3, 128, 16, 8, 128, 0.0, 64),
    (1, 64, 4, 4, 32, 0.0, 64),
]

F32 = dict(atol=3e-5, rtol=3e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)


def _qkv(seed, b, t, s, h, kv, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, t, h, d).astype(np.float32) * 0.3,
            rng.randn(b, s, kv, d).astype(np.float32) * 0.3,
            rng.randn(b, s, kv, d).astype(np.float32) * 0.3)


def _t(*xs, dtype=torch.float32):
    return [torch.from_numpy(x).to(dtype) for x in xs]


def _j(*xs, dtype=jnp.float32):
    return [jnp.asarray(x, dtype) for x in xs]


def _f32(x) -> np.ndarray:
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,t,h,kv,d,causal,window,cap,bq,bk", FLASH_CASES)
def test_flash_plain_matches_reference_f32(b, t, h, kv, d, causal, window,
                                           cap, bq, bk):
    q, k, v = _qkv(t * h + d, b, t, t, h, kv, d)
    got = FA.flash_attention(*_t(q, k, v), causal=causal, window=window,
                             softcap=cap)
    kern = flash_R(*_j(q, k, v), causal=causal, window=window, softcap=cap,
                   block_q=bq, block_k=bk, interpret=True)
    want = ref_R.attention_ref(*_j(q, k, v), causal=causal, window=window,
                               softcap=cap)
    np.testing.assert_allclose(_f32(got), _f32(kern), **F32)
    np.testing.assert_allclose(_f32(got), _f32(want), **F32)


def test_flash_plain_matches_reference_bf16():
    """bf16 inputs: the cast of the softmax weights to q's dtype before
    the PV product is what sets the 2e-2 bound."""
    q, k, v = _qkv(5, 1, 128, 128, 4, 2, 64)
    got = FA.flash_attention(*_t(q, k, v, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    kern = flash_R(*_j(q, k, v, dtype=jnp.bfloat16), block_q=64,
                   block_k=64, interpret=True)
    want = ref_R.attention_ref(*_j(q, k, v, dtype=jnp.bfloat16))
    np.testing.assert_allclose(_f32(got), _f32(kern), **BF16)
    np.testing.assert_allclose(_f32(got), _f32(want), **BF16)


def test_flash_scale_and_gemma_shape():
    """An explicit scale (gemma2's 1/sqrt(144), not 1/sqrt(head_dim)),
    softcap 50, a window and g = 2 at once."""
    q, k, v = _qkv(6, 1, 96, 96, 4, 2, 16)
    kw = dict(causal=True, window=40, softcap=50.0, scale=1.0 / 12.0)
    got = FA.flash_attention(*_t(q, k, v), **kw)
    kern = flash_R(*_j(q, k, v), block_q=32, block_k=32, interpret=True,
                   **kw)
    np.testing.assert_allclose(_f32(got), _f32(kern), **F32)


def test_flash_q_block_with_every_kv_block_masked():
    """t > s under a window: the q blocks past s + window - 1 see no key.
    The reference's kernel skips every kv block there and returns 0
    (acc / max(l, 1e-30)); its untiled oracle, and so the port's plain
    version, returns the mean of V.  Where a row sees a key, all agree."""
    b, t, s, h, kv, d, window = 1, 128, 64, 4, 2, 32, 16
    q, k, v = _qkv(7, b, t, s, h, kv, d)
    got = FA.flash_attention(*_t(q, k, v), window=window)
    kern = np.asarray(flash_R(*_j(q, k, v), window=window, block_q=32,
                              block_k=32, interpret=True))
    want = ref_R.attention_ref(*_j(q, k, v), window=window)
    np.testing.assert_allclose(_f32(got), _f32(want), **F32)
    seen = s + window - 1                  # first position with no key
    np.testing.assert_allclose(_f32(got)[:, :seen], kern[:, :seen], **F32)
    assert not kern[:, seen:].any()
    np.testing.assert_allclose(
        _f32(got)[:, seen:],
        np.broadcast_to(np.repeat(v.mean(1), h // kv, axis=1)[:, None],
                        (b, t - seen, h, d)), **F32)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

def _decode_inputs(seed, b, s, h, kv, d):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, d).astype(np.float32) * 0.3
    k = rng.randn(b, s, kv, d).astype(np.float32) * 0.3
    v = rng.randn(b, s, kv, d).astype(np.float32) * 0.3
    return q, k, v, rng.rand(b, s) > 0.3


@pytest.mark.parametrize("b,s,h,kv,d,cap,bk", DECODE_CASES)
def test_decode_plain_matches_reference(b, s, h, kv, d, cap, bk):
    q, k, v, valid = _decode_inputs(s + h, b, s, h, kv, d)
    got = DA.decode_attention(*_t(q, k, v), torch.from_numpy(valid),
                              softcap=cap)
    kern = decode_R(*_j(q, k, v), jnp.asarray(valid), softcap=cap,
                    block_k=bk, interpret=True)
    want = ref_R.decode_attention_ref(*_j(q, k, v), jnp.asarray(valid),
                                      softcap=cap)
    np.testing.assert_allclose(_f32(got), _f32(kern), **F32)
    np.testing.assert_allclose(_f32(got), _f32(want), **F32)


def test_decode_plain_matches_reference_bf16():
    q, k, v, valid = _decode_inputs(11, 2, 300, 8, 4, 128)
    got = DA.decode_attention(*_t(q, k, v, dtype=torch.bfloat16),
                              torch.from_numpy(valid), softcap=50.0,
                              scale=1.0 / 12.0)
    kern = decode_R(*_j(q, k, v, dtype=jnp.bfloat16), jnp.asarray(valid),
                    softcap=50.0, scale=1.0 / 12.0, block_k=128,
                    interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(kern), **BF16)


def test_decode_ring_mask_single_survivor():
    """Only one valid slot -> the output is that slot's V row."""
    b, s, h, kv, d = 1, 64, 4, 2, 32
    q, k, v, _ = _decode_inputs(12, b, s, h, kv, d)
    valid = np.zeros((b, s), bool)
    valid[0, 17] = True
    got = DA.decode_attention(*_t(q, k, v), torch.from_numpy(valid))
    kern = decode_R(*_j(q, k, v), jnp.asarray(valid), block_k=32,
                    interpret=True)
    want = np.repeat(v[0, 17], h // kv, 0).reshape(1, h, d)
    np.testing.assert_allclose(_f32(got), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_f32(got), _f32(kern), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# logits that reach the cap
# ---------------------------------------------------------------------------

#: q and k at 2x unit scale give logits of std ~4 (max ~14) at d = 64,
#: so a softcap of 2, 5 or 50 changes the output far beyond the bounds;
#: V at unit scale keeps the outputs O(1) against the bounds.
CAPS = [2.0, 5.0, 50.0]


def _at_cap(seed, b, t, s, h, kv, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, t, h, d).astype(np.float32) * 2.0,
            rng.randn(b, s, kv, d).astype(np.float32) * 2.0,
            rng.randn(b, s, kv, d).astype(np.float32),
            rng.rand(b, s) > 0.3)


def _assert_beyond(a, b, tol):
    assert not np.allclose(_f32(a), _f32(b), **tol), \
        "dropping the softcap stays within the bound"


@pytest.mark.parametrize("cap", CAPS)
def test_flash_plain_at_the_cap(cap):
    """f32 against the reference's kernel and oracle, bf16 against its
    oracle; without the softcap the output leaves both bounds."""
    q, k, v, _ = _at_cap(21, 1, 128, 128, 4, 2, 64)
    kw = dict(window=48, softcap=cap)
    got = FA.flash_attention(*_t(q, k, v), **kw)
    kern = flash_R(*_j(q, k, v), block_q=32, block_k=32, interpret=True,
                   **kw)
    np.testing.assert_allclose(_f32(got), _f32(kern), **F32)
    _assert_beyond(FA.flash_attention(*_t(q, k, v), window=48), got, F32)
    got = FA.flash_attention(*_t(q, k, v, dtype=torch.bfloat16), **kw)
    want = ref_R.attention_ref(*_j(q, k, v, dtype=jnp.bfloat16), **kw)
    np.testing.assert_allclose(_f32(got), _f32(want), **BF16)
    _assert_beyond(FA.flash_attention(*_t(q, k, v, dtype=torch.bfloat16),
                                      window=48), got, BF16)


@pytest.mark.parametrize("cap", CAPS)
def test_decode_plain_at_the_cap(cap):
    q, k, v, valid = _at_cap(22, 2, 1, 300, 8, 4, 64)
    q, vm = q[:, 0], torch.from_numpy(valid)
    got = DA.decode_attention(*_t(q, k, v), vm, softcap=cap)
    kern = decode_R(*_j(q, k, v), jnp.asarray(valid), softcap=cap,
                    block_k=128, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(kern), **F32)
    _assert_beyond(DA.decode_attention(*_t(q, k, v), vm), got, F32)
    got = DA.decode_attention(*_t(q, k, v, dtype=torch.bfloat16), vm,
                              softcap=cap)
    want = ref_R.decode_attention_ref(*_j(q, k, v, dtype=jnp.bfloat16),
                                      jnp.asarray(valid), softcap=cap)
    np.testing.assert_allclose(_f32(got), _f32(want), **BF16)
    _assert_beyond(DA.decode_attention(*_t(q, k, v, dtype=torch.bfloat16),
                                       vm), got, BF16)


# ---------------------------------------------------------------------------
# dispatch and refusals
# ---------------------------------------------------------------------------

def test_wrappers_run_the_plain_version_on_cpu_and_count_nothing():
    FA.reset_launch_counts()
    DA.reset_launch_counts()
    q, k, v = _t(*_qkv(13, 1, 20, 20, 4, 2, 8))
    assert torch.equal(ops.attention(q, k, v, window=5),
                       FA.flash_attention_plain(q, k, v, window=5))
    valid = torch.ones((1, 20), dtype=torch.bool)
    assert torch.equal(ops.decode_attn(q[:, 0], k, v, valid),
                       DA.decode_attention_plain(q[:, 0], k, v, valid))
    assert FA.LAUNCHES == {"flash_attention": 0}
    assert DA.LAUNCHES == {"decode_attention": 0}


def test_refusals():
    q, k, v = _t(*_qkv(14, 1, 4, 4, 2, 1, 257))
    with pytest.raises(ValueError, match="MAX_HEAD_DIM"):
        FA.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="MAX_HEAD_DIM"):
        DA.decode_attention(q[:, 0], k, v, torch.ones((1, 4), dtype=bool))
    q, k, v = _t(*_qkv(15, 1, 4, 4, 3, 2, 8))
    with pytest.raises(ValueError, match="multiple"):
        FA.flash_attention(q, k, v)
    q, k, v = _t(*_qkv(16, 1, 4, 4, 2, 1, 8), dtype=torch.float16)
    with pytest.raises(TypeError):
        FA.flash_attention(q, k, v)


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_flash_kernel_on_cuda():
    """Every FLASH_CASES shape, f32 and bf16, against the plain version."""
    dev = _cuda()
    FA.reset_launch_counts()
    n = 0
    for b, t, h, kv, d, causal, window, cap, _, _ in FLASH_CASES:
        for dtype, tol in ((torch.float32, F32), (torch.bfloat16, BF16)):
            q, k, v = [x.to(dev) for x in _t(*_qkv(t, b, t, t, h, kv, d),
                                             dtype=dtype)]
            kw = dict(causal=causal, window=window, softcap=cap)
            got = FA.flash_attention(q, k, v, **kw)
            want = FA.flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            np.testing.assert_allclose(_f32(got.cpu()), _f32(want.cpu()),
                                       **tol)
            n += 1
    assert FA.LAUNCHES["flash_attention"] == n


@pytest.mark.cuda
def test_decode_kernel_on_cuda():
    dev = _cuda()
    DA.reset_launch_counts()
    for b, s, h, kv, d, cap, _ in DECODE_CASES:
        q, k, v, valid = _decode_inputs(s, b, s, h, kv, d)
        q, k, v = [x.to(dev) for x in _t(q, k, v)]
        valid = torch.from_numpy(valid).to(dev)
        got = DA.decode_attention(q, k, v, valid, softcap=cap)
        want = DA.decode_attention_plain(q, k, v, valid, softcap=cap)
        torch.cuda.synchronize()
        np.testing.assert_allclose(_f32(got.cpu()), _f32(want.cpu()), **F32)
    assert DA.LAUNCHES["decode_attention"] == len(DECODE_CASES)


@pytest.mark.cuda
def test_kernels_at_the_cap_on_cuda():
    """Logits past the cap: each kernel against its plain version run in
    float32 on the same values (the plain bf16 version rounds its logits
    to bf16, which at |logit| ~ 14 is beyond the bound by itself)."""
    dev = _cuda()
    for cap in CAPS:
        q, k, v, valid = _at_cap(23, 1, 128, 128, 4, 2, 64)
        vm = torch.from_numpy(valid).to(dev)
        for dtype, tol in ((torch.float32, F32), (torch.bfloat16, BF16)):
            q_, k_, v_ = [x.to(dev) for x in _t(q, k, v, dtype=dtype)]
            q32, k32, v32 = q_.float(), k_.float(), v_.float()
            got = FA.flash_attention(q_, k_, v_, window=48, softcap=cap)
            want = FA.flash_attention_plain(q32, k32, v32, window=48,
                                            softcap=cap)
            np.testing.assert_allclose(_f32(got.cpu()), _f32(want.cpu()),
                                       **tol)
            got = DA.decode_attention(q_[:, -1], k_, v_, vm, softcap=cap)
            want = DA.decode_attention_plain(q32[:, -1], k32, v32, vm,
                                             softcap=cap)
            np.testing.assert_allclose(_f32(got.cpu()), _f32(want.cpu()),
                                       **tol)


@pytest.mark.parametrize("mod,src", [(FA, "flash_attention.cu"),
                                     (DA, "decode_attention.cu")])
def test_ctypes_signatures_match_the_sources(mod, src):
    """Each C entry point's declared argtypes count its parameters in
    the CUDA source (ctypes would otherwise pass too few)."""
    import os
    import re
    path = os.path.join(os.path.dirname(FA.__file__), "..", "csrc", src)
    with open(path) as f:
        text = f.read()
    for sym, (argtypes, _) in mod._SIGNATURES.items():
        m = re.search(r'extern "C" [^(]*\b' + sym + r"\(([^)]*)\)", text)
        assert m, sym
        params = [p for p in m.group(1).split(",") if p.strip()]
        assert len(params) == len(argtypes), (sym, params)
