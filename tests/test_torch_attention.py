"""The port's attention kernels against the reference's.

``repro_torch.kernels.flash_attention`` / ``decode_attention`` run
their plain versions on a CPU tensor; here those are held to the
reference's Pallas kernels (interpret mode) and to its untiled oracles
(``repro.kernels.ref``) on the same inputs, made with numpy from a
seed, at the reference's own tolerances (``tests/test_kernels.py``):
atol = rtol = 3e-5 in float32, 2e-2 in bfloat16.

``decode_plan`` (the split kernel's launch geometry) is checked at
every shape the port decodes at, and a numpy model of the kernel's
tiling and merge is held to the reference's oracle.

The CUDA kernels run only on a card: the ``cuda``-marked tests hold
each against its plain version there and skip elsewhere.
"""

import importlib

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
from repro_torch.kernels import ops                         # noqa: E402

# the modules (the package binds the functions under these names)
DA = importlib.import_module("repro_torch.kernels.decode_attention")
FA = importlib.import_module("repro_torch.kernels.flash_attention")
FR = importlib.import_module("repro_torch.kernels.fluid_reduce")
KP = importlib.import_module("repro_torch.kernels.cc_step")
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
# decode attention: the split kernel's launch plan and its tiling
# ---------------------------------------------------------------------------

def _plan_shapes():
    """(b, s, h, kv, d) the port decodes at: every config and smoke
    config (4 slots, its own head shape), the serve cell's global and
    local caches, DECODE_CASES and the tiling edges chip_smoke holds."""
    from repro_torch.configs import ARCHS, get_config, get_smoke_config
    shapes = {(4, 4352, 32, 16, 128), (4, 4096, 32, 16, 128),
              (2, 4352, 32, 16, 128), (1, 1, 8, 8, 64)}
    for a in ARCHS:
        for c in (get_config(a), get_smoke_config(a)):
            shapes.add((4, 128 if c is get_smoke_config(a) else 4096,
                        c.n_heads, c.n_kv_heads, c.head_dim))
    shapes |= {case[:5] for case in DECODE_CASES}
    shapes |= {(2, 67, 2 * grp, 2, d) for d in (8, 32, 64, 128, 256)
               for grp in (1, 2, 4, 8)}
    return sorted(shapes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_plan_covers_every_key_once(dtype):
    """At every shape: the tiles of a split and the splits take each key
    once, the units take each (batch, query head) once, and no CTA needs
    shared memory past the card's 232,448 B.  On the split kernel the
    lanes of a warp take each 16-byte chunk of a row once; on the group
    kernel (bf16, g 6-16) one CTA takes all g heads of a kv head, so
    each K/V row is loaded once per kv head."""
    esize = torch.empty((), dtype=dtype).element_size()
    for b, s, h, kv, d in _plan_shapes():
        pl = DA.decode_plan(b, s, h, kv, d, dtype)
        g = h // kv
        assert pl.keys_per_split % pl.tile == 0
        assert pl.part_rows in (b * h * pl.nsplit, 0)
        assert pl.smem_bytes <= 232_448
        seen = np.zeros(s, int)
        if pl.kernel == "group":
            assert dtype == torch.bfloat16 and 6 <= g <= 16, (b, s, h, kv, d)
            assert pl.gc == g and pl.tile == DA.GROUP_TILE
            assert pl.units == pl.ctas == b * kv * pl.nsplit
            for sp in range(pl.nsplit):
                k0 = sp * pl.keys_per_split
                seen[k0:min(s, k0 + pl.keys_per_split)] += 1
            assert (seen == 1).all(), (b, s, h, kv, d)
            continue
        assert g % pl.gc == 0 and pl.gc in (1, 2, 4)
        nch = -(-d * esize // 16)
        assert pl.lpr & (pl.lpr - 1) == 0 and pl.lpr <= 32
        chunks = sorted(lig + c * pl.lpr for lig in range(pl.lpr)
                        for c in range(pl.vpl))
        assert chunks[:nch] == list(range(nch))      # each chunk once
        assert pl.tile == pl.rows * 32 // pl.lpr
        for sp in range(pl.nsplit):
            k0, k1 = sp * pl.keys_per_split, min(s, (sp + 1)
                                                 * pl.keys_per_split)
            for t0 in range(k0, k1, pl.tile):
                for r in range(pl.rows):
                    for grp in range(32 // pl.lpr):
                        key = t0 + r * (32 // pl.lpr) + grp
                        if key < k1:
                            seen[key] += 1
        assert (seen == 1).all(), (b, s, h, kv, d)
        assert pl.units == b * pl.nsplit * kv * (g // pl.gc)
        assert pl.ctas * DA.WARPS_PER_CTA >= pl.units
        assert pl.part_rows == b * h * pl.nsplit


def test_decode_plan_fills_the_card_at_the_serve_shape():
    """The serve cell's 64 (batch, kv head) pairs are split so the units
    fill 132 SMs x 16 resident warps in one wave, to within the rounding
    of a split to the tile; the merge stages at most 8.5 KB of split
    weights (and as much of l)."""
    want = DA.N_SM * DA.CTAS_PER_SM * DA.WARPS_PER_CTA
    for s in (4352, 4096):
        pl = DA.decode_plan(4, s, 32, 16, 128, torch.bfloat16)
        assert (pl.gc, pl.lpr, pl.vpl, pl.tile) == (2, 16, 1, 8)
        assert 0.9 * want <= pl.units <= want, pl
        assert pl.ctas <= DA.N_SM * DA.CTAS_PER_SM
    for shape in _plan_shapes():
        pl = DA.decode_plan(*shape, torch.float32)
        b, _, h, kv, _ = shape
        per_split = b * kv * (h // kv // pl.gc)
        assert pl.units <= max(want, per_split), (shape, pl)
        assert pl.nsplit * 4 <= 8704, (shape, pl)


def test_decode_plan_refusals():
    with pytest.raises(ValueError, match="MAX_HEAD_DIM"):
        DA.decode_plan(1, 8, 4, 2, 257, torch.float32)
    with pytest.raises(ValueError, match="multiple"):
        DA.decode_plan(1, 8, 6, 4, 64, torch.float32)


def _decode_model(q, k, v, valid, plan, *, softcap, scale):
    """numpy model of csrc/decode_attention.cu at float64: each unit's
    online softmax tile by tile (a tile with no valid slot skipped, one
    max and one rescale a tile), its partial (m, l, acc), then the merge
    in split order with acc / max(l, 1e-30)."""
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    neg = -1e30
    part_m = np.full((b, h, plan.nsplit), neg)
    part_l = np.zeros((b, h, plan.nsplit))
    part_a = np.zeros((b, h, plan.nsplit, d))
    for bb in range(b):
        for hh in range(h):
            kh = hh // g
            for sp in range(plan.nsplit):
                k0 = sp * plan.keys_per_split
                k1 = min(s, k0 + plan.keys_per_split)
                m, l, acc = neg, 0.0, np.zeros(d)
                for t0 in range(k0, k1, plan.tile):
                    keys = np.arange(t0, min(t0 + plan.tile, k1))
                    ok = valid[bb, keys]
                    if not ok.any():
                        continue
                    x = k[bb, keys, kh].astype(np.float64) @ q[bb, hh] * scale
                    if softcap > 0:
                        x = np.tanh(x / softcap) * softcap
                    m_new = max(m, x[ok].max())
                    corr = 1.0 if m == neg else np.exp(m - m_new)
                    p = np.where(ok, np.exp(x - m_new), 0.0)
                    acc = acc * corr + p @ v[bb, keys, kh]
                    l, m = l * corr + p.sum(), m_new
                part_m[bb, hh, sp], part_l[bb, hh, sp] = m, l
                part_a[bb, hh, sp] = acc
    top = part_m.max(-1, keepdims=True)
    w = np.where(part_m == neg, 0.0, np.exp(part_m - top))
    den = np.maximum((part_l * w).sum(-1), 1e-30)
    return (part_a * w[..., None]).sum(-2) / den[..., None]


@pytest.mark.parametrize("b,s,h,kv,d,cap", [
    (2, 77, 8, 2, 64, 50.0),        # a ragged last tile and split
    (1, 300, 8, 1, 32, 0.0),        # g = 8 in two head chunks
    (2, 130, 4, 4, 256, 5.0),       # g = 1, two chunks a lane in f32
])
def test_decode_tiling_model_matches_reference(b, s, h, kv, d, cap):
    """The kernel's tiling and merge, modelled in numpy, against the
    reference's untiled oracle: a whole tile invalid, a split with no
    valid slot (its partial merges with weight 0) and, for batch row 1
    of the first case, no valid slot at all (the kernel's 0)."""
    q, k, v, valid = _decode_inputs(s + d, b, s, h, kv, d)
    plan = DA.decode_plan(b, s, h, kv, d, torch.float32)
    valid[:, plan.tile:2 * plan.tile] = False
    valid[:, plan.keys_per_split:2 * plan.keys_per_split] = False
    empty = b > 1 and s == 77
    if empty:
        valid[1] = False
    scale = 1.0 / np.sqrt(d)
    got = _decode_model(q, k, v, valid, plan, softcap=cap, scale=scale)
    want = _f32(ref_R.decode_attention_ref(*_j(q, k, v), jnp.asarray(valid),
                                           softcap=cap))
    keep = slice(0, 1) if empty else slice(None)
    np.testing.assert_allclose(got[keep], want[keep], **F32)
    if empty:
        assert not got[1].any()


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
# the two CUDA routes of flash_attention
# ---------------------------------------------------------------------------

def _chip_smoke():
    """``chip_smoke.py`` at the repo root (its module level imports no
    torch and touches no card)."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _route_cases():
    """(dtype, head_dim) of every config and smoke config of the repo, the
    reference's FLASH_CASES and chip_smoke's FLASH_EDGE / FLASH_CAP."""
    from repro_torch.configs import ARCHS, get_config, get_smoke_config
    dims = {c.head_dim for a in ARCHS
            for c in (get_config(a), get_smoke_config(a))}
    dims |= {case[4] for case in FLASH_CASES}
    cs = _chip_smoke()
    dims |= {case[4] for case in cs.FLASH_EDGE + cs.FLASH_CAP}
    return sorted(dims)


def test_route_is_the_tensor_core_kernel_exactly_for_bf16_at_64_128_and_256():
    dims = _route_cases()
    assert {8, 16, 32, 64, 128, 256} <= set(dims), dims
    for d in dims:
        for dtype in (torch.float32, torch.bfloat16):
            want = ("tensor_core" if dtype == torch.bfloat16
                    and d in (64, 128, 256) else "cuda_core")
            assert FA._route(dtype, d) == want, (dtype, d)
    assert FA.TC_HEAD_DIMS == (64, 128, 256)


def test_cpu_calls_count_no_route():
    FA.reset_launch_counts()
    q, k, v = _t(*_qkv(17, 1, 16, 16, 4, 2, 64), dtype=torch.bfloat16)
    FA.flash_attention(q, k, v)
    assert FA.ROUTES == {"tensor_core": 0, "cuda_core": 0}
    assert FA.LAUNCHES == {"flash_attention": 0}


def _cu_source(src):
    import os
    path = os.path.join(os.path.dirname(FA.__file__), "..", "csrc", src)
    with open(path) as f:
        return f.read()


def test_tensor_core_shared_memory_fits_the_card():
    """The tensor-core kernels' dynamic shared memory, from the constants
    in their source, at each routed head_dim is at most the 232,448 B a
    block may use on an H100.  d 64 / 256 (``flash_tc_kernel``):
    alignment slack, a Q block of TC_BM rows, TC_STAGES pairs of K/V
    tiles of bk_of(d) keys (TC_BK at d 64, TC_BK_D256 at d 256), 3
    mbarriers a stage.  d 128 (``flash_tc128_kernel``, launched with
    ``smem128_bytes``): the slack, two Q blocks (an item's and the
    next's), T128_STAGES pairs of 128-key K/V tiles, 4 mbarriers a
    stage."""
    import re
    text = _cu_source("flash_attention.cu")
    c = {name: int(re.search(r"constexpr int " + name + r" = (\d+);",
                             text).group(1))
         for name in ("TC_BM", "TC_BK", "TC_BK_D256", "TC_STAGES",
                      "TC_ALIGN", "T128_STAGES")}
    assert "return TC_ALIGN + q_bytes(D) + TC_STAGES * 2 * tile_bytes(D)" \
        in text
    assert "return D == 256 ? TC_BK_D256 : TC_BK;" in text
    assert "tile_bytes(int D) { return bk_of(D) * D * 2; }" in text
    assert ("return TC_ALIGN + 2 * q_bytes(128) + T128_STAGES * 2 * "
            "tile_bytes(128)\n         + T128_STAGES * 4 * 8;") in text
    assert "constexpr int D = 128, BK = 128, ST = T128_STAGES;" in text
    assert "if constexpr (D == 128) {" in text
    assert "const int bytes = smem128_bytes();" in text
    for d in FA.TC_HEAD_DIMS:
        bk = c["TC_BK_D256"] if d == 256 else c["TC_BK"]
        if d == 128:
            total = (c["TC_ALIGN"] + 2 * c["TC_BM"] * d * 2
                     + c["T128_STAGES"] * 2 * bk * d * 2
                     + c["T128_STAGES"] * 4 * 8)
        else:
            total = (c["TC_ALIGN"] + c["TC_BM"] * d * 2
                     + c["TC_STAGES"] * 2 * bk * d * 2
                     + c["TC_STAGES"] * 3 * 8)
        assert total <= 232_448, (d, total)
        assert bk % 16 == 0
    assert c["TC_BM"] == 128 and 256 in FA.TC_HEAD_DIMS


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
def test_flash_tensor_core_route_on_cuda():
    """bfloat16 at d = 64 and 128 (the FLASH_CASES shapes, gemma2's heads
    with its scale, window and softcap, and logits past caps 2, 5, 50)
    takes the tensor-core kernel, within 2e-2 of the plain version run in
    float32 on the same values; ROUTES counts every launch there."""
    dev = _cuda()
    cases = [c[:8] + (0.3,) for c in FLASH_CASES if c[4] in FA.TC_HEAD_DIMS]
    cases += [(1, 600, 32, 16, 128, True, 256, 50.0, 0.3),
              (2, 300, 32, 16, 128, True, None, 50.0, 0.3)]
    cases += [(1, 256, 4, 2, 64, True, 48, cap, 2.0) for cap in CAPS]
    FA.reset_launch_counts()
    for b, t, h, kv, d, causal, window, cap, sd in cases:
        q, k, v = _qkv(t + d, b, t, t, h, kv, d)
        q, k, v = [x.to(dev) for x in _t(q * sd / 0.3, k * sd / 0.3, v,
                                         dtype=torch.bfloat16)]
        kw = dict(causal=causal, window=window, softcap=cap,
                  scale=1.0 / 12.0 if h == 32 else None)
        got = FA.flash_attention(q, k, v, **kw)
        want = FA.flash_attention_plain(q.float(), k.float(), v.float(),
                                        **kw)
        torch.cuda.synchronize()
        np.testing.assert_allclose(_f32(got.cpu()), _f32(want.cpu()),
                                   **BF16)
    assert FA.ROUTES == {"tensor_core": len(cases), "cuda_core": 0}
    assert FA.LAUNCHES["flash_attention"] == len(cases)


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
    # the kernels' tiling edges: d 8-256, GQA groups 1-8 (bf16 at g 8 and
    # d 64-256: the group kernel), a cache no multiple of the tile with
    # its second tile invalid, and batch row 1 with no valid slot (the
    # kernel's 0); the library's tile is the plan's
    lib = DA._lib()
    for d in (8, 32, 64, 128, 256):
        for grp in (1, 2, 4, 8):
            for dtype, tol in ((torch.float32, F32), (torch.bfloat16, BF16)):
                plan = DA.decode_plan(2, 1, 2 * grp, 2, d, dtype)
                assert plan.tile == (
                    lib.da_group_tile_keys() if plan.kernel == "group"
                    else lib.da_tile_keys(int(dtype == torch.bfloat16), d,
                                          plan.gc))
                s = 5 * plan.tile + 3
                q, k, v, valid = _decode_inputs(d + grp, 2, s, 2 * grp, 2, d)
                valid[:, plan.tile:2 * plan.tile] = False
                valid[1] = False
                q, k, v = [x.to(dev) for x in _t(q, k, v, dtype=dtype)]
                vm = torch.from_numpy(valid).to(dev)
                got = DA.decode_attention(q, k, v, vm, softcap=50.0)
                want = DA.decode_attention_plain(q, k, v, vm, softcap=50.0)
                torch.cuda.synchronize()
                np.testing.assert_allclose(_f32(got[:1].cpu()),
                                           _f32(want[:1].cpu()), **tol)
                assert not got[1].any()
                assert torch.equal(got, DA.decode_attention(
                    q, k, v, vm, softcap=50.0))


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
                                     (DA, "decode_attention.cu"),
                                     (FR, "fluid_reduce.cu"),
                                     (KP, "cc_step.cu")])
def test_ctypes_signatures_match_the_sources(mod, src):
    """Each C entry point's declared argtypes count its parameters in
    the CUDA source (ctypes would otherwise pass too few), and each
    pointer, int, long long and float parameter is declared as one; the
    library exports every C entry point the wrapper declares and no
    other."""
    import ctypes
    import re
    text = _cu_source(src)
    kinds = {ctypes.c_void_p: "ptr", ctypes.c_int: "int",
             ctypes.c_float: "float", ctypes.c_longlong: "long long"}
    for sym, (argtypes, _) in mod._SIGNATURES.items():
        m = re.search(r'extern "C" [^(]*\b' + sym + r"\(([^)]*)\)", text)
        assert m, sym
        params = [p for p in m.group(1).split(",") if p.strip()]
        assert len(params) == len(argtypes), (sym, params)
        for p, a in zip(params, argtypes):
            want = ("ptr" if "*" in p else "float" if "float" in p
                    else "long long" if "long long" in p
                    else "int" if re.search(r"\bint\b", p) else p)
            assert kinds.get(a) == want, (sym, p, a)
    exported = set(re.findall(r'extern "C" [^(]*?\b(\w+)\(', text))
    assert exported == set(mod._SIGNATURES), exported
    if mod is FA:
        assert "fa_flash_attention_tc" in exported
