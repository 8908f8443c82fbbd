"""The tensor-core route of ``flash_attention`` at head_dim 128
(``csrc/flash_attention.cu``, ``tc::flash_tc128_kernel``) modelled on the
CPU.

The kernel runs only on a card.  Here a numpy model follows its walk:
a persistent grid of min(items, SMs) CTAs, each taking the items
(q block of TC_BM folded rows, batch x kv head) that ``item_of`` gives
it, heaviest first and in a snake over rounds; the kv tiles of an item
[jlo, jlo + n) of 128 keys; and the order of its pipelined update, one
stream of tiles a CTA across its items: S of tile i is computed and its
softmax run (m, l, corr in float32, masked logits -1e30, corr 1 while m
is -1e30) before P V of tile i - 1 is added to O, then O is carried by
corr (or restarted by corr = 0 at an item's first tile, after the item
before is stored), and P is rounded to bfloat16 before its P V.  An
item with no tile writes zeros.  The model is held to the reference's
``flash_attention`` (interpret mode, as ``tests/test_kernels.py`` runs
it) at the bfloat16 bound, 2e-2, on bfloat16-valued inputs; and the work
list is checked to visit every (q block, batch x kv head) once, heaviest
first.  The constants come from the kernel's source, so a change to the
tile shape or the work order there shows here.  These tests hold the
model; the ``cuda``-marked test in ``tests/test_torch_attention_cuda.py``
holds the kernel.
"""

import importlib
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp                                     # noqa: E402

from repro.kernels import ref as ref_R                      # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention as flash_R                              # noqa: E402

FA = importlib.import_module("repro_torch.kernels.flash_attention")
BF16 = dict(atol=2e-2, rtol=2e-2)
LOG2E = np.float32(1.4426950408889634)
NEG = np.float32(-1e30)
#: SMs of an H100 (the grid the kernel launches there)
H100_SMS = 132


def _source() -> str:
    path = os.path.join(os.path.dirname(FA.__file__), "..", "csrc",
                        "flash_attention.cu")
    with open(path) as f:
        return f.read()


def _constants() -> dict:
    """TC_BM and the d 128 kernel's tile and ring from the source; the
    work order's formula as written there."""
    text = _source()
    bm = int(re.search(r"constexpr int TC_BM = (\d+);", text).group(1))
    st = int(re.search(r"constexpr int T128_STAGES = (\d+);", text).group(1))
    d, bk = map(int, re.search(
        r"constexpr int D = (\d+), BK = (\d+), ST = T128_STAGES;",
        text).groups())
    assert "return r * G + ((r & 1) ? G - 1 - c : c);" in text
    assert "const int qb = nqb - 1 - w / nbkv, bkv = w % nbkv;" in text
    return dict(BM=bm, BK=bk, D=d, STAGES=st)


def item_of(c: int, r: int, grid: int) -> int:
    """The item CTA c takes in round r (``tc::item_of``)."""
    return r * grid + (grid - 1 - c if r & 1 else c)


def _item(w, *, nbkv, nqb, kv, nrows, g, s, causal, window, BM, BK):
    """``tc::item128``: q block, batch, kv head, positions, kv tiles."""
    qb, bkv = nqb - 1 - w // nbkv, w % nbkv
    r0 = qb * BM
    rlast = min(r0 + BM, nrows) - 1
    qfirst, qlast = r0 // g, rlast // g
    jhi = -(-s // BK)
    if causal:
        jhi = min(jhi, qlast // BK + 1)
    jlo = 0
    if window is not None and qfirst - window - BK + 1 >= 0:
        jlo = (qfirst - window - BK + 1) // BK + 1
    return dict(w=w, qb=qb, bb=bkv // kv, kh=bkv % kv, r0=r0,
                rows=np.arange(r0, rlast + 1), qfirst=qfirst, qlast=qlast,
                jlo=jlo, n=max(jhi - jlo, 0))


def work_list(b, t, s, h, kv, *, causal, window, n_sm=H100_SMS):
    """Each CTA's items in the order it walks them (``item_of`` over
    rounds), as the kernel's producer and consumers both do."""
    k = _constants()
    g = h // kv
    nrows = t * g
    nqb, nbkv = -(-nrows // k["BM"]), b * kv
    total = nqb * nbkv
    grid = min(total, n_sm)
    kw = dict(nbkv=nbkv, nqb=nqb, kv=kv, nrows=nrows, g=g, s=s,
              causal=causal, window=window, BM=k["BM"], BK=k["BK"])
    ctas = []
    for c in range(grid):
        items, r = [], 0
        while r * grid < total:
            w = item_of(c, r, grid)
            r += 1
            if w < total:
                items.append(_item(w, **kw))
        ctas.append(items)
    return ctas


def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def tc128_model(q, k, v, *, causal, window, softcap, scale, n_sm=H100_SMS):
    """numpy model of ``flash_tc128_kernel`` on q [b, t, h, 128], k, v
    [b, s, kv, 128] (float32 holding bfloat16 values): the output in
    float32 before its rounding to bfloat16."""
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    BK = _constants()["BK"]
    f32 = np.float32
    scale = f32(scale if scale is not None else 1.0 / np.sqrt(d))
    if softcap > 0:
        qk_mul, cap2 = scale / f32(softcap), f32(softcap) * LOG2E
    else:
        qk_mul, cap2 = scale * LOG2E, f32(0.0)
    nrows = t * g
    # rows position-major: [b, kv, t * g, d]
    qf = q.reshape(b, t, kv, g, d).transpose(0, 2, 1, 3, 4).reshape(
        b, kv, nrows, d)
    kf, vf = k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3)
    out = np.full((b, kv, nrows, d), np.nan, f32)

    def store(x, acc, lsum):
        out[x["bb"], x["kh"], x["rows"]] = \
            acc / np.maximum(lsum, f32(1e-30))[:, None]

    for items in work_list(b, t, s, h, kv, causal=causal, window=window,
                           n_sm=n_sm):
        stream = []                     # (item, tile) in walk order
        for x in items:
            if x["n"] == 0:             # no key visible: zeros
                out[x["bb"], x["kh"], x["rows"]] = 0.0
            stream += [(x, x["jlo"] + i) for i in range(x["n"])]
        prev, pending = None, None      # P V of the tile before, in flight
        for x, j in stream:
            first = prev is not x
            rows, qpos = x["rows"], x["rows"] // g
            keys = np.arange(j * BK, min(j * BK + BK, s))
            # S of this tile: logits in log2 units, then the masks
            sc = (qf[x["bb"], x["kh"], rows]
                  @ kf[x["bb"], x["kh"], keys].T).astype(f32) * qk_mul
            if softcap > 0:
                sc = (cap2 * np.tanh(sc)).astype(f32)
            ok = np.ones(sc.shape, bool)
            if causal:
                ok &= keys[None, :] <= qpos[:, None]
            if window is not None:
                ok &= keys[None, :] > qpos[:, None] - window
            sc = np.where(ok, sc, NEG).astype(f32)
            if first:
                l_done = l if prev is not None else None
                m = np.full(len(rows), NEG, f32)
                l = np.zeros(len(rows), f32)
            m_new = np.maximum(m, sc.max(-1))
            corr = np.where(m == NEG, f32(1.0), np.exp2(m - m_new)).astype(
                f32)
            m = m_new
            l = (l * corr).astype(f32)
            p = np.where(sc == NEG, f32(0.0),
                         np.exp2(sc - m[:, None])).astype(f32)
            l = (l + p.sum(-1)).astype(f32)
            # P V of the tile before lands, then O moves to the new m
            if pending is not None:
                acc = (acc + pending[0] @ pending[1]).astype(f32)
            if first:
                if prev is not None:
                    store(prev, acc, l_done)
                acc = np.zeros((len(rows), d), f32)
            else:
                acc = (acc * corr[:, None]).astype(f32)
            pending = (_bf16(p), vf[x["bb"], x["kh"], keys])
            prev = x
        if pending is not None:
            acc = (acc + pending[0] @ pending[1]).astype(f32)
            store(prev, acc, l)
    assert not np.isnan(out).any()
    out = out.reshape(b, kv, t, g, d).transpose(0, 2, 1, 3, 4)
    return out.reshape(b, t, h, d)


def _inputs(seed, b, t, s, h, kv, qk_sd):
    rng = np.random.RandomState(seed)
    return (_bf16(rng.randn(b, t, h, 128) * qk_sd),
            _bf16(rng.randn(b, s, kv, 128) * qk_sd),
            _bf16(rng.randn(b, s, kv, 128)))


#: (b, t, s, h, kv, causal, window, cap, n_sm): causal at g 1 (deepseek's
#: MHA) and g 6 (internvl2's and mixtral's 48/8), a window that skips
#: whole tiles, softcaps 5 and 50, a ragged s, t < 128, non-causal, a
#: grid of 3 CTAs (several rounds of the snake) and the H100's 132
MODEL_CASES = [
    (2, 300, 300, 2, 2, True, None, 0.0, 3),
    (1, 300, 300, 6, 1, True, None, 0.0, 5),
    (1, 260, 260, 12, 2, True, 64, 50.0, 3),
    (2, 200, 200, 6, 1, True, 64, 5.0, H100_SMS),
    (1, 333, 333, 6, 1, False, None, 0.0, 4),
    (2, 80, 80, 2, 2, True, None, 50.0, 3),
    (1, 40, 40, 6, 1, True, None, 0.0, H100_SMS),
]


@pytest.mark.parametrize("b,t,s,h,kv,causal,window,cap,n_sm", MODEL_CASES)
def test_walk_model_matches_reference_kernel(b, t, s, h, kv, causal, window,
                                             cap, n_sm):
    q, k, v = _inputs(t + h + n_sm, b, t, s, h, kv, 2.0 if cap else 1.0)
    got = tc128_model(q, k, v, causal=causal, window=window, softcap=cap,
                      scale=None, n_sm=n_sm)
    j = [jnp.asarray(x) for x in (q, k, v)]
    kern = flash_R(*j, causal=causal, window=window, softcap=cap,
                   block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern), **BF16)
    want = ref_R.attention_ref(*j, causal=causal, window=window,
                               softcap=cap)
    np.testing.assert_allclose(got, np.asarray(want), **BF16)
    if cap:                     # the softcap is what is checked
        nocap = tc128_model(q, k, v, causal=causal, window=window,
                            softcap=0.0, scale=None, n_sm=n_sm)
        assert not np.allclose(nocap, got, **BF16)


def test_walk_model_writes_zeros_where_no_key_is_visible():
    """t > s under a window: the items past s + window - 1 have no kv
    tile (all skipped) and write zeros, as the reference's kernel does."""
    b, t, s, h, kv, window = 1, 512, 64, 6, 1, 16
    q, k, v = _inputs(3, b, t, s, h, kv, 1.0)
    items = [x for c in work_list(b, t, s, h, kv, causal=True,
                                  window=window, n_sm=4) for x in c]
    assert any(x["n"] == 0 for x in items)
    got = tc128_model(q, k, v, causal=True, window=window, softcap=50.0,
                      scale=1.0 / 12, n_sm=4)
    kern = np.asarray(flash_R(*[jnp.asarray(x) for x in (q, k, v)],
                              window=window, softcap=50.0, scale=1.0 / 12,
                              block_q=64, block_k=64, interpret=True))
    seen = s + window - 1
    np.testing.assert_allclose(got[:, :seen], kern[:, :seen], **BF16)
    assert not got[:, seen:].any() and not kern[:, seen:].any()


#: the served d 128 shapes (b, t, h, kv, window): internvl2-26b and
#: deepseek-moe-16b at 2048, mixtral-8x22b under its 4096 window,
#: gemma2-27b's serve prefill (global and local)
SERVED = [(2, 2048, 48, 8, None), (2, 2048, 16, 16, None),
          (2, 2048, 48, 8, 4096), (4, 4200, 32, 16, None),
          (4, 4200, 32, 16, 4096)]


@pytest.mark.parametrize("b,t,h,kv,window", SERVED)
def test_work_list_visits_every_item_once_heaviest_first(b, t, h, kv,
                                                         window):
    """Every (q block, batch x kv head) exactly once over the grid; in
    walk order the kv tile counts never grow (heaviest first) for
    causal attention without a window; the snake leaves the CTAs' loads
    within one item of each other; each CTA's K/V tiles are the items'
    tiles in its order (what the producer streams through the ring)."""
    k = _constants()
    ctas = work_list(b, t, t, h, kv, causal=True, window=window)
    g = h // kv
    nqb = -(-t * g // k["BM"])
    seen = sorted((x["qb"], x["bb"], x["kh"]) for c in ctas for x in c)
    assert seen == sorted((qb, bb, kh) for qb in range(nqb)
                          for bb in range(b) for kh in range(kv))
    assert len(ctas) == min(H100_SMS, nqb * b * kv)
    by_w = sorted((x for c in ctas for x in c), key=lambda x: x["w"])
    assert [x["qb"] for x in by_w] == sorted(
        (x["qb"] for x in by_w), reverse=True)
    if window is None:
        n = [x["n"] for x in by_w]
        assert n == sorted(n, reverse=True)
    loads = [sum(x["n"] for x in c) for c in ctas]
    assert max(loads) - min(loads) <= max(x["n"] for x in by_w)
    for c in ctas:                     # the stream the ring carries
        tiles = [(x["bb"], x["kh"], x["jlo"] + i) for x in c
                 for i in range(x["n"])]
        assert len(tiles) == sum(x["n"] for x in c)


def test_work_list_on_a_small_grid():
    """More CTAs than items: one item each (the grid is min(items,
    SMs)); fewer: the snake's rounds alternate direction."""
    ctas = work_list(1, 100, 100, 2, 2, causal=True, window=None)
    assert [len(c) for c in ctas] == [1, 1]
    ctas = work_list(2, 300, 300, 6, 1, causal=True, window=None, n_sm=4)
    order = [[x["w"] for x in c] for c in ctas]
    assert order[0][:2] == [0, 7] and order[3][:2] == [3, 4]
