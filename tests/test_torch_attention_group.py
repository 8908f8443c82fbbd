"""The two attention designs for recurrentgemma-9b's served shapes,
modelled on the CPU and held to the reference.

* ``flash_attention`` at bf16, head_dim 256, on the tensor-core route
  (``tc::flash_tc_kernel`` in ``csrc/flash_attention.cu``): 64-key K/V
  tiles where d 64 / 128 take 128.  A numpy model of its walk, built
  from the tile constants parsed from the source (``TC_BM``, ``bk_of``),
  repeats the CTA's folded rows, the kv tiles it skips, the tiles where
  masks are evaluated, logits in log2 units (``ex2``), corr frozen while
  m == -1e30, P rounded to bf16 before P V and acc / max(l, 1e-30).
* ``decode_attention``'s group kernel (``decode_group_kernel`` in
  ``csrc/decode_attention.cu``): one CTA a (batch, kv head, split) with
  all g query heads, 4 warps of 16 keys in each 64-key tile, each warp
  its own online softmax, the warps merged in warp order, the splits
  merged in split order.  A numpy model of that order, on the plan
  ``decode_plan`` computes, is held to the reference.

Both models take bf16-rounded inputs and are held to the reference's
untiled oracle (``repro.kernels.ref``) run in float32 on the same
values, and to its Pallas kernels in interpret mode run in bfloat16, at
the reference's bfloat16 bound, 2e-2 (``tests/test_kernels.py``).  These
tests hold the models; the ``cuda``-marked tests of
``tests/test_torch_attention_cuda.py`` hold the kernels on a card.
"""

import importlib
import os
import re

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

DA = importlib.import_module("repro_torch.kernels.decode_attention")
FA = importlib.import_module("repro_torch.kernels.flash_attention")
BF16 = dict(atol=2e-2, rtol=2e-2)
#: the card's shared memory a block may use (H100, opt-in maximum)
SMEM_LIMIT = 232_448
LOG2E = np.float32(1.4426950408889634)
NEG = -1e30


def _source(name: str) -> str:
    path = os.path.join(os.path.dirname(FA.__file__), "..", "csrc", name)
    with open(path) as f:
        return f.read()


def _const(text: str, name: str) -> int:
    return int(re.search(r"constexpr int " + name + r" = (\d+);",
                         text).group(1))


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bfloat16 (nearest even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _inputs(seed, *shapes, sd=(0.3, 0.3, 0.3)):
    rng = np.random.RandomState(seed)
    return [_bf16(rng.randn(*sh).astype(np.float32) * s)
            for sh, s in zip(shapes, sd)]


# ---------------------------------------------------------------------------
# flash attention: the tensor-core route's tile walk at d 256
# ---------------------------------------------------------------------------

def _tc_geometry() -> dict:
    """The tensor-core kernel's constants as the source writes them: rows
    a CTA, keys a tile at d 64 / 128 and at d 256, ring depth, alignment
    slack, and setmaxnreg's counts at d 256."""
    text = _source("flash_attention.cu")
    text = text[text.index("namespace tc {"):]
    geo = {n: _const(text, n) for n in ("TC_BM", "TC_BK", "TC_BK_D256",
                                        "TC_STAGES", "TC_ALIGN",
                                        "TC_THREADS")}
    assert "return D == 256 ? TC_BK_D256 : TC_BK;" in text
    assert "return D == 256 ? 24 : 40;" in text       # producer_regs
    assert "return D == 256 ? 240 : 232;" in text     # consumer_regs
    geo["regs"] = {64: (40, 232), 128: (40, 232), 256: (24, 240)}
    return geo


def _bk(d: int) -> int:
    geo = _tc_geometry()
    return geo["TC_BK_D256"] if d == 256 else geo["TC_BK"]


def _tc_model(q, k, v, *, causal, window, softcap, scale):
    """numpy float32 model of ``tc::flash_tc_kernel``: CTAs of TC_BM
    folded rows (R = pos * g + group) of one (batch, kv head), kv tiles
    [jlo, jhi) of bk_of(d) keys, masks only where the tile is not all
    visible, the softmax in log2 units, P rounded to bf16 for P V while
    l sums the float32 weights."""
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    BR, BK = _tc_geometry()["TC_BM"], _bk(d)
    f32 = np.float32
    scale = f32(scale if scale is not None else 1.0 / np.sqrt(d))
    if softcap > 0:
        qk_mul, cap2 = scale / f32(softcap), f32(softcap) * LOG2E
    else:
        qk_mul, cap2 = scale * LOG2E, f32(0.0)
    neg = f32(NEG)
    nrows = t * g
    qf = q.reshape(b, t, kv, g, d).transpose(0, 2, 1, 3, 4)
    qf = qf.reshape(b, kv, nrows, d)
    kf, vf = k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3)
    out = np.zeros((b, kv, nrows, d), f32)
    ntiles = -(-s // BK)
    for r0 in range(0, nrows, BR):
        rows = np.arange(r0, min(r0 + BR, nrows))
        qpos = rows // g
        qfirst, qlast = r0 // g, rows[-1] // g
        jhi = min(ntiles, qlast // BK + 1) if causal else ntiles
        jlo = 0
        if window is not None and qfirst - window - BK + 1 >= 0:
            jlo = (qfirst - window - BK + 1) // BK + 1
        m = np.full((b, kv, len(rows)), neg, f32)
        l = np.zeros((b, kv, len(rows)), f32)
        acc = np.zeros((b, kv, len(rows), d), f32)
        for j in range(jlo, jhi):
            k0 = j * BK
            keys = np.arange(k0, min(k0 + BK, s))
            x = (qf[:, :, rows] @ kf[:, :, keys].transpose(0, 1, 3, 2))
            x = x.astype(f32)
            x = (np.tanh(x * qk_mul) * cap2 if softcap > 0
                 else x * qk_mul).astype(f32)
            visible = (k0 + BK <= s and (not causal or k0 + BK - 1 <= qfirst)
                       and (window is None or k0 > qlast - window))
            ok = np.ones((len(rows), len(keys)), bool)
            if not visible:
                if causal:
                    ok &= keys[None, :] <= qpos[:, None]
                if window is not None:
                    ok &= keys[None, :] > qpos[:, None] - window
            x = np.where(ok, x, neg).astype(f32)
            m_new = np.maximum(m, x.max(-1))
            corr = np.where(m == neg, f32(1.0),
                            np.exp2(m - m_new)).astype(f32)
            p = np.where(x == neg, 0.0,
                         np.exp2(x - m_new[..., None])).astype(f32)
            l = (l * corr + p.sum(-1)).astype(f32)
            acc = (acc * corr[..., None] + _bf16(p) @ vf[:, :, keys]
                   ).astype(f32)
            m = m_new
        out[:, :, rows] = acc / np.maximum(l, f32(1e-30))[..., None]
    out = out.reshape(b, kv, t, g, d).transpose(0, 2, 1, 3, 4)
    return out.reshape(b, t, h, d)


#: (b, t, h, kv, d, causal, window, cap, bq, bk of the reference's kernel):
#: recurrentgemma's heads (16/1, d 256) under its window, ragged, with
#: a softcap, non-causal, t shorter than one tile and crossing CTAs;
#: the d 64 / 128 walks (128-key tiles) beside them
TC_CASES = [
    (1, 200, 16, 1, 256, True, 64, 0.0, 64, 64),
    (2, 130, 16, 1, 256, True, None, 50.0, 64, 64),
    (1, 40, 16, 1, 256, True, None, 0.0, 32, 32),
    (1, 97, 8, 2, 256, False, None, 0.0, 32, 32),
    (1, 160, 4, 4, 256, True, 48, 5.0, 32, 32),
    (1, 300, 8, 4, 128, True, 128, 30.0, 64, 64),
    (2, 150, 4, 1, 64, True, None, 0.0, 64, 64),
]


@pytest.mark.parametrize("b,t,h,kv,d,causal,window,cap,bq,bk", TC_CASES)
def test_tc_walk_model_matches_reference(b, t, h, kv, d, causal, window,
                                         cap, bq, bk):
    """The tensor-core walk against the reference's oracle (float32 on
    the same bf16 values) and its Pallas kernel (interpret, bf16)."""
    sd = 2.0 if cap else 0.3
    q, k, v = _inputs(t + d + h, (b, t, h, d), (b, t, kv, d),
                      (b, t, kv, d), sd=(sd, sd, 1.0))
    kw = dict(causal=causal, window=window, softcap=cap)
    got = _tc_model(q, k, v, scale=None, **kw)
    j32 = [jnp.asarray(x) for x in (q, k, v)]
    want = np.asarray(ref_R.attention_ref(*j32, **kw))
    np.testing.assert_allclose(got, want, **BF16)
    jbf = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    kern = flash_R(*jbf, block_q=bq, block_k=bk, interpret=True, **kw)
    np.testing.assert_allclose(got, np.asarray(kern, np.float32), **BF16)
    if cap:
        nocap = np.asarray(ref_R.attention_ref(*j32, causal=causal,
                                               window=window))
        assert not np.allclose(nocap, want, **BF16)


def test_tc_walk_model_skips_every_tile_behind_the_window_at_d256():
    """t > s under a window at d 256: positions past s + window - 1 see
    no key; the walk skips every tile there and writes 0, as the
    reference's kernel does."""
    b, t, s, h, kv, d, window = 1, 256, 64, 16, 1, 256, 16
    q, k, v = _inputs(4, (b, t, h, d), (b, s, kv, d), (b, s, kv, d))
    got = _tc_model(q, k, v, causal=True, window=window, softcap=0.0,
                    scale=None)
    kern = np.asarray(flash_R(*[jnp.asarray(x, jnp.bfloat16)
                                for x in (q, k, v)],
                              window=window, block_q=64, block_k=64,
                              interpret=True), np.float32)
    seen = s + window - 1
    np.testing.assert_allclose(got[:, :seen], kern[:, :seen], **BF16)
    assert not got[:, seen:].any() and not kern[:, seen:].any()


@pytest.mark.parametrize("d", [64, 128, 256])
def test_tc_tile_fits_the_registers_and_shared_memory(d):
    """Per consumer thread, S (BK / 2 floats), O (d / 2) and P (BK / 4
    bf16 pairs) fit setmaxnreg's count with room for addresses and the
    softmax state; the three warpgroups' counts fit the SM's 65,536
    registers; the shared memory fits the card; tiles are whole wgmma
    k-steps."""
    geo = _tc_geometry()
    bk = _bk(d)
    prod, cons = geo["regs"][d]
    assert bk / 2 + d / 2 + bk / 4 <= cons - 48, (d, bk, cons)
    assert 128 * prod + 2 * 128 * cons <= 65_536
    assert geo["TC_THREADS"] == 384
    for r in (prod, cons):
        assert 24 <= r <= 256 and r % 8 == 0
    smem = (geo["TC_ALIGN"] + geo["TC_BM"] * d * 2
            + geo["TC_STAGES"] * 2 * bk * d * 2 + geo["TC_STAGES"] * 3 * 8)
    assert smem <= SMEM_LIMIT, (d, smem)
    assert bk % 16 == 0 and bk <= 256 and d % 64 == 0
    if d == 256:
        assert smem == 197_680
        # a third stage would not fit
        assert smem + 2 * bk * d * 2 > SMEM_LIMIT


# ---------------------------------------------------------------------------
# decode attention: the group kernel's plan, split and merge
# ---------------------------------------------------------------------------

def _group_constants() -> dict:
    text = _source("decode_attention.cu")
    return {n: _const(text, n) for n in ("GW", "GK", "GM", "G_STAGES")}


def test_group_constants_match_the_source():
    """The wrapper's group constants and shared-memory formula are the
    source's, and the widest CTA fits the card."""
    c = _group_constants()
    assert (c["GK"], c["GM"], c["G_STAGES"]) == (
        DA.GROUP_TILE, DA.GROUP_MAX_HEADS, DA.GROUP_STAGES)
    assert c["GK"] == 16 * c["GW"]              # 16 keys a warp
    text = _source("decode_attention.cu")
    assert "return GM * D * 2 + G_STAGES * 2 * GK * D * 2;" in text
    for d in DA.GROUP_HEAD_DIMS:
        assert f"launch_group<{d}>" in text
        assert DA.group_smem_bytes(d) <= SMEM_LIMIT
        # the warps' partials [GW][GM][d + 8] and their (m, l, weights,
        # M, L) reuse the ring
        ring = c["G_STAGES"] * 2 * c["GK"] * d * 2
        assert 4 * (c["GW"] * c["GM"] * (d + 8) + 3 * c["GW"] * c["GM"]
                    + 2 * c["GM"]) <= ring
    assert DA.group_smem_bytes(256) == 204_800


def _group_model(q, k, v, valid, plan, *, softcap, scale):
    """numpy model of the group kernel and the merge kernel at float64
    (P rounded to bf16 for P V): each CTA (batch, kv head, split) walks
    its 64-key tiles, warp w taking keys 16 w .. 16 w + 15 of each with
    its own (m, l, O) for every head of the group; the warps merge in
    warp order, then the splits in split order, acc / max(l, 1e-30)."""
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    warps = plan.tile // 16
    ks, nsplit = plan.keys_per_split, plan.nsplit
    part_m = np.full((b, h, nsplit), NEG)
    part_l = np.zeros((b, h, nsplit))
    part_a = np.zeros((b, h, nsplit, d))
    for bb in range(b):
        for kh in range(kv):
            heads = kh * g + np.arange(g)
            qh = q[bb, heads].astype(np.float64)
            for sp in range(nsplit):
                k0, k1 = sp * ks, min(s, (sp + 1) * ks)
                wm = np.full((warps, g), NEG)
                wl = np.zeros((warps, g))
                wo = np.zeros((warps, g, d))
                for t0 in range(k0, k1, plan.tile):
                    for w in range(warps):
                        keys = np.arange(t0 + 16 * w,
                                         min(t0 + 16 * w + 16, k1))
                        if not len(keys):
                            continue
                        ok = valid[bb, keys]
                        x = qh @ k[bb, keys, kh].astype(np.float64).T
                        x = x * scale
                        if softcap > 0:
                            x = np.tanh(x / softcap) * softcap
                        rmax = np.where(ok, x, NEG).max(-1)
                        m_new = np.maximum(wm[w], rmax)
                        corr = np.where(wm[w] == NEG, 1.0,
                                        np.exp(wm[w] - m_new))
                        x = np.where(ok, x, m_new[:, None])
                        p = np.where(ok, np.exp(x - m_new[:, None]), 0.0)
                        wl[w] = wl[w] * corr + p.sum(-1)
                        wo[w] = (wo[w] * corr[:, None]
                                 + _bf16(p) @ v[bb, keys, kh])
                        wm[w] = m_new
                top = wm.max(0)
                wt = np.where(wm == NEG, 0.0, np.exp(wm - top))
                part_m[bb, heads, sp] = top
                part_l[bb, heads, sp] = (wl * wt).sum(0)
                part_a[bb, heads, sp] = (wo * wt[..., None]).sum(0)
    if nsplit == 1:
        return part_a[:, :, 0] / np.maximum(part_l[:, :, 0],
                                            1e-30)[..., None]
    top = part_m.max(-1, keepdims=True)
    w = np.where(part_m == NEG, 0.0, np.exp(part_m - top))
    den = np.maximum((part_l * w).sum(-1), 1e-30)
    return (part_a * w[..., None]).sum(-2) / den[..., None]


#: (b, s, h, kv, d, cap, n_sm): recurrentgemma's g 16 at d 256 (several
#: splits of 64 keys), g 8 at d 64 and 128 over 2 kv heads, g 12, g 6
#: over 2 kv heads, and a plan of one split (n_sm 1: the group kernel
#: writes the output)
GROUP_CASES = [
    (2, 300, 16, 1, 256, 0.0, 132),
    (2, 200, 16, 1, 256, 50.0, 132),
    (3, 130, 16, 2, 64, 0.0, 132),
    (2, 257, 8, 1, 128, 5.0, 132),
    (2, 150, 12, 1, 128, 0.0, 132),
    (2, 170, 12, 2, 128, 0.0, 132),
    (2, 100, 16, 1, 256, 0.0, 1),
]


@pytest.mark.parametrize("b,s,h,kv,d,cap,n_sm", GROUP_CASES)
def test_group_model_matches_reference(b, s, h, kv, d, cap, n_sm):
    """The group kernel's split-and-merge order against the reference's
    oracle (float32 on the same bf16 values) and its Pallas kernel
    (interpret, bf16): the ring's mask in the first split, a whole split
    with no valid slot (its partial merges with weight 0) and batch row
    1 with none at all (the kernel's 0)."""
    sd = 2.0 if cap else 0.3
    q, k, v = _inputs(s + h + d, (b, h, d), (b, s, kv, d), (b, s, kv, d),
                      sd=(sd, sd, 1.0))
    valid = np.random.RandomState(s).rand(b, s) > 0.3
    plan = DA.decode_plan(b, s, h, kv, d, torch.bfloat16, n_sm=n_sm)
    assert plan.kernel == "group" and plan.gc == h // kv
    assert (plan.nsplit == 1) == (n_sm == 1)
    if plan.nsplit > 2:
        valid[:, plan.keys_per_split:2 * plan.keys_per_split] = False
    valid[1] = False
    scale = 1.0 / np.sqrt(d)
    got = _group_model(q, k, v, valid, plan, softcap=cap, scale=scale)
    j32 = [jnp.asarray(x) for x in (q, k, v)]
    want = np.asarray(ref_R.decode_attention_ref(
        *j32, jnp.asarray(valid), softcap=cap))
    np.testing.assert_allclose(got[:1], want[:1], **BF16)
    np.testing.assert_allclose(got[2:], want[2:], **BF16)
    assert not got[1].any()
    kern = decode_R(*[jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)],
                    jnp.asarray(valid), softcap=cap, block_k=64,
                    interpret=True)
    np.testing.assert_allclose(got[:1], np.asarray(kern, np.float32)[:1],
                               **BF16)


def test_group_plan_at_recurrentgemmas_shape():
    """b 2, a full 2048-slot ring, 16/1 heads, d 256: 32 splits of 64
    keys (64 CTAs, one an SM), each key once, each (batch, query head)
    once, each K/V row loaded once, and partials a quarter of the
    cache's bytes, where the split plan wrote twice them."""
    b, s, h, kv, d = 2, 2048, 16, 1, 256
    pl = DA.decode_plan(b, s, h, kv, d, torch.bfloat16)
    assert (pl.kernel, pl.gc, pl.tile, pl.keys_per_split, pl.nsplit) == (
        "group", 16, 64, 64, 32)
    assert pl.ctas == pl.units == b * kv * pl.nsplit <= DA.N_SM
    cache = 2 * b * s * kv * d * 2                   # K and V, bf16
    partial = pl.part_rows * (d + 2) * 4
    assert partial * 3 < cache, (partial, cache)
    old = DA.decode_plan(b, s, h, kv, d, torch.bfloat16, kernel="split")
    assert old.kernel == "split" and old.part_rows * (d + 2) * 4 > cache
    assert old.keys_per_split == 8 and old.nsplit == 256
    assert pl.smem_bytes == DA.group_smem_bytes(d) <= SMEM_LIMIT


def _group_walk(pl, b, s, kv):
    """(loads a (batch, kv head, key), heads a (batch, query head)) of
    the group kernel's walk under plan ``pl``: CTA (batch, kv head,
    split) loads each key of its split once and takes the g heads of
    its kv head."""
    loads = np.zeros((b, kv, s), int)
    g = pl.gc
    heads = np.zeros((b, kv * g), int)
    for cta in range(pl.ctas):
        sp, bk = cta % pl.nsplit, cta // pl.nsplit
        bb, kh = bk // kv, bk % kv
        k0, k1 = sp * pl.keys_per_split, min(s, (sp + 1) * pl.keys_per_split)
        for t0 in range(k0, k1, pl.tile):
            for w in range(pl.tile // 16):
                for key in range(t0 + 16 * w, min(t0 + 16 * w + 16, k1)):
                    loads[bb, kh, key] += 1
        if sp == 0:
            heads[bb, kh * g:(kh + 1) * g] += 1
    return loads, heads


@pytest.mark.parametrize("b,s,h,kv,d", [
    (2, 2048, 16, 1, 256), (4, 4096, 16, 1, 256), (4, 4096, 24, 2, 128),
    (2, 67, 16, 2, 64), (1, 1, 8, 1, 128), (3, 1000, 32, 4, 256),
    (66, 500, 16, 1, 256)])
def test_group_plan_covers_every_key_once(b, s, h, kv, d):
    """Every key of every (batch, kv head) loaded exactly once (one CTA
    takes all g heads of a kv head), every (batch, query head) taken
    once, at most one wave of CTAs, splits a multiple of the tile."""
    pl = DA.decode_plan(b, s, h, kv, d, torch.bfloat16)
    assert pl.kernel == "group"
    assert pl.keys_per_split % pl.tile == 0 and pl.tile == DA.GROUP_TILE
    assert pl.nsplit == -(-s // pl.keys_per_split)
    assert pl.ctas <= max(DA.N_SM, b * kv)
    loads, heads = _group_walk(pl, b, s, kv)
    assert (loads == 1).all() and (heads == 1).all()
    assert pl.part_rows == (b * h * pl.nsplit if pl.nsplit > 1 else 0)


def test_decode_plan_picks_the_kernel_by_shape():
    """The group kernel exactly for bf16 at g 6-16 and d 64 / 128 / 256
    (recurrentgemma's g 16, starcoder2's 12, mixtral's and internvl2's
    6); gemma2's g 2, phi3's 4, qwen2.5's 5 and deepseek's 1 stay on the
    split kernel, as does float32; forcing the group kernel
    where it cannot run raises."""
    from repro_torch.configs import ARCHS, get_config
    picked = {}
    for a in ARCHS:
        c = get_config(a)
        g = c.n_heads // c.n_kv_heads
        for dt in (torch.bfloat16, torch.float32):
            pl = DA.decode_plan(2, 2048, c.n_heads, c.n_kv_heads,
                                c.head_dim, dt)
            want = ("group" if dt == torch.bfloat16 and 6 <= g <= 16
                    and c.head_dim in (64, 128, 256) else "split")
            assert pl.kernel == want, (a, dt, pl)
            picked[a, dt] = pl.kernel
    assert picked["recurrentgemma-9b", torch.bfloat16] == "group"
    assert picked["gemma2-27b", torch.bfloat16] == "split"
    assert picked["mixtral-8x22b", torch.bfloat16] == "group"
    assert picked["phi3-medium-14b", torch.bfloat16] == "split"
    for d in (8, 32, 100):
        assert DA.decode_plan(2, 64, 16, 1, d, torch.bfloat16).kernel \
            == "split"
    assert DA.decode_plan(2, 64, 32, 1, 128, torch.bfloat16).kernel \
        == "split"                                    # g 32 > one M
    assert DA.decode_plan(2, 64, 12, 2, 128, torch.bfloat16,
                          kernel="group").gc == 6
    with pytest.raises(ValueError, match="group kernel"):
        DA.decode_plan(2, 64, 16, 1, 256, torch.float32, kernel="group")
    with pytest.raises(ValueError, match="group kernel"):
        DA.decode_plan(2, 64, 32, 1, 128, torch.bfloat16, kernel="group")
    with pytest.raises(ValueError, match="no kernel"):
        DA.decode_plan(2, 64, 16, 1, 256, torch.bfloat16, kernel="warp")


def test_cpu_calls_count_no_plan():
    DA.reset_launch_counts()
    q, k, v = _inputs(3, (2, 16, 256), (2, 64, 1, 256), (2, 64, 1, 256))
    valid = torch.ones((2, 64), dtype=torch.bool)
    got = DA.decode_attention(*[torch.from_numpy(x).to(torch.bfloat16)
                                for x in (q, k, v)], valid)
    assert got.shape == (2, 16, 256) and got.dtype == torch.bfloat16
    assert DA.PLANS == {"split": 0, "group": 0}
    assert DA.LAUNCHES == {"decode_attention": 0}
