"""GQA attention: causal / sliding-window variants with a KV cache, and
the encoder-decoder's bidirectional and cross attention (port of
``repro.models.attention``; ``cache_spec`` gives a cache's logical
sharding dims).

KV cache layout: ``k, v: [batch, cache_len, n_kv, head_dim]`` plus
``pos``, the absolute number of tokens already cached: a ``[]`` int32
tensor on the cache's device, shared by every row of a batch, as in the
reference.  Nothing on the decode path reads it on the host, so a
serving step can be captured as a CUDA graph.  For sliding-window layers
the cache is a ring buffer of ``min(max_len, window)`` slots.  Unlike
the reference's functional updates, the port writes a cache's ``k`` and
``v`` in place (``_cache_write_*`` return a ``KVCache`` over the same
storage and a new ``pos``), so a serving step does not copy every
layer's cache.

With ``cfg.use_pallas`` attention runs through ``kernels.ops``: the CUDA
kernels on the card, their plain versions on the CPU.  Without it,
``_mha`` / ``_blockwise_attn`` run plain on any device.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..dist.sharding import (ambient_mesh, logical_sharding, on_shards, pin,
                             placements_of, shard, zeros)
from ..kernels import ops
from .config import ModelConfig
from .layers import ParamDef, dot, rope, softcap

NEG_INF = -1e30
LOCAL_KINDS = ("local", "moe_local")


class KVCache(NamedTuple):
    k: torch.Tensor       # [b, cache_len, n_kv, head_dim]
    v: torch.Tensor
    pos: torch.Tensor     # [] int32: absolute tokens already cached


def attn_defs(cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    defs = {
        "wq": ParamDef((d, h, hd), ("fsdp", "heads", None), "scaled"),
        "wk": ParamDef((d, kv, hd), ("fsdp", "kv_heads", None), "scaled"),
        "wv": ParamDef((d, kv, hd), ("fsdp", "kv_heads", None), "scaled"),
        "wo": ParamDef((h, hd, d), ("heads", None, "fsdp"), "scaled"),
    }
    if cfg.qkv_bias:
        defs |= {
            "bq": ParamDef((h, hd), ("heads", None), "zeros"),
            "bk": ParamDef((kv, hd), ("kv_heads", None), "zeros"),
            "bv": ParamDef((kv, hd), ("kv_heads", None), "zeros"),
        }
    return defs


def init_cache(cfg: ModelConfig, batch: int, max_len: int, kind: str,
               dtype, device) -> KVCache:
    """kind: 'attn' full cache; 'local' ring buffer bounded by window."""
    length = min(max_len, cfg.window) if kind in LOCAL_KINDS else max_len
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
    dims = cache_spec(cfg, batch, max_len, kind)
    return KVCache(k=zeros(shape, dims.k, dtype, device),
                   v=zeros(shape, dims.v, dtype, device),
                   pos=zeros((), dims.pos, torch.int32, device))


def cache_spec(cfg: ModelConfig, batch: int, max_len: int, kind: str):
    """Logical dims for the cache (SP over length when heads indivisible)."""
    return KVCache(k=("cache_batch", "kv_seq", None, None),
                   v=("cache_batch", "kv_seq", None, None),
                   pos=())


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('btd,dhk->bthk', x, w)."""
    b, t, _ = x.shape
    d, h, hd = w.shape
    # port pins: the heads' layout on the flat side of each view, so
    # that neither the view nor its gradient's splits a dim unevenly
    w2 = pin(w.to(x.dtype).reshape(d, h * hd), "fsdp", "heads", None,
             shape=(d, h, hd))
    y = pin(dot(x, w2), "batch", "seq", "act_heads", None, shape=(b, t, h, hd))
    return y.reshape(b, t, h, hd)


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum('bthk,hkd->btd', out, wo)."""
    b, t, h, hd = out.shape
    o2 = pin(out.reshape(b, t, h * hd), "batch", "seq", "act_heads", None,
             shape=(b, t, h, hd))
    w2 = pin(wo.to(out.dtype).reshape(h * hd, wo.shape[-1]), "heads", None,
             "fsdp", shape=wo.shape)
    return dot(o2, w2)


def _on_heads(fn, q, k, v, mask):
    """``fn(q, k, v, mask)``, an attention core, on each rank's batch rows
    and KV-head groups (``on_shards``): heads split only where the KV
    heads split, so each rank holds whole groups, and the mask
    ([b | 1, t, s] or None) splits with the batch.  The plain tensor
    ops of the cores (grouped einsums, online softmax) are the same math
    shard by shard.  Outside a mesh, ``fn(q, k, v, mask)``."""
    mesh = ambient_mesh()
    if mesh is None:
        return fn(q, k, v, mask)
    b, t, _, hd = q.shape
    heads = logical_sharding(("batch", None, "act_heads", None),
                             (b, t, k.shape[2], hd), mesh).placements
    if mask is None:
        return on_shards(lambda a, b_, c: fn(a, b_, c, None), (q, k, v),
                         (heads, heads, heads), list(heads))
    mpl = logical_sharding(("batch", None, None), tuple(mask.shape),
                           mesh).placements
    return on_shards(fn, (q, k, v, mask), (heads, heads, heads, mpl),
                     list(heads))


def _project_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return q, k, v


def _scale(cfg: ModelConfig) -> float:
    return cfg.query_scale or 1.0 / math.sqrt(cfg.head_dim)


def _mha(q, k, v, cfg: ModelConfig, mask) -> torch.Tensor:
    """q: [b,t,h,hd]; k,v: [b,s,kv,hd]; mask: [b,t,s] bool or None."""
    b, t, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, t, kv, h // kv, hd)
    logits = torch.einsum("btkgd,bskd->bkgts", qg, k).float()
    logits = logits * _scale(cfg)
    logits = softcap(logits, cfg.softcap_attn)
    if mask is not None:
        logits = torch.where(mask[:, None, None, :, :], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", w, v)
    return out.reshape(b, t, h, hd)


def _blockwise_attn(q, k, v, cfg: ModelConfig, *, causal: bool,
                    window: int | None, q_offset: int = 0):
    """Online-softmax attention over KV blocks of ``cfg.attn_block_k``,
    a Python loop (the reference's ``lax.scan``): the plain twin of
    ``flash_attention``, with peak memory O(t x block_k)."""
    b, t, h, hd = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    bk = min(cfg.attn_block_k, s)
    nb = -(-s // bk)
    qg = (q.reshape(b, t, kv, g, hd) * _scale(cfg)).float()
    qpos = q_offset + torch.arange(t, device=q.device)
    m = torch.full((b, kv, g, t), -math.inf, device=q.device)
    l = torch.zeros((b, kv, g, t), device=q.device)
    acc = torch.zeros((b, kv, g, t, hd), device=q.device)
    for i in range(nb):
        kblk = k[:, i * bk:(i + 1) * bk].float()
        vblk = v[:, i * bk:(i + 1) * bk].float()
        pad = bk - kblk.shape[1]
        if pad:
            kblk = torch.nn.functional.pad(kblk, (0, 0, 0, 0, 0, pad))
            vblk = torch.nn.functional.pad(vblk, (0, 0, 0, 0, 0, pad))
        logits = torch.einsum("btkgd,bskd->bkgts", qg, kblk)
        logits = softcap(logits, cfg.softcap_attn)
        kpos = i * bk + torch.arange(bk, device=q.device)
        mask = (kpos[None, :] < s).expand(t, bk)
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window is not None:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        logits = torch.where(mask, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1))
        corr = torch.where(m == -math.inf, 1.0, torch.exp(m - m_new))
        p = torch.exp(logits - m_new[..., None])
        p = torch.where(mask, p, 0.0)
        l = l * corr + p.sum(-1)
        acc = (acc * corr[..., None]
               + torch.einsum("bkgts,bskd->bkgtd", p, vblk))
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, h, hd).to(q.dtype)


def _causal_mask(t: int, s: int, q_offset: int, window: int | None,
                 device) -> torch.Tensor:
    qpos = torch.arange(t, device=device)[:, None] + q_offset
    kpos = torch.arange(s, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m                                        # [t, s]


def attention(p: dict, cfg: ModelConfig, kind: str, x: torch.Tensor,
              positions: torch.Tensor, cache: Optional[KVCache] = None,
              use_rope: bool = True):
    """Self-attention for train / prefill / decode.

    Train/prefill: cache is None, or x holds a prompt of > 1 token whose
    K/V are written into the cache.  Decode: x is [b, 1, d] and the
    cache holds the history.  Returns (out [b, t, d], cache).
    """
    window = cfg.window if kind in LOCAL_KINDS else None
    q, k, v = _project_qkv(p, cfg, x)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    # attention.py:173 shard(q, "batch", "seq", "act_heads", None)
    q = shard(q, "batch", "seq", "act_heads", None)

    def _self_attn(qq, kk, vv):
        if cfg.use_pallas:
            return ops.attention(qq, kk, vv, causal=True, window=window,
                                 softcap=cfg.softcap_attn, scale=_scale(cfg))
        if cfg.attn_impl == "blockwise":
            return _on_heads(
                lambda a, b_, c, _m: _blockwise_attn(a, b_, c, cfg,
                                                     causal=True,
                                                     window=window),
                qq, kk, vv, None)
        mask = _causal_mask(qq.shape[1], kk.shape[1], 0, window,
                            qq.device)[None]
        return _on_heads(lambda a, b_, c, m: _mha(a, b_, c, cfg, m),
                         qq, kk, vv, mask)

    if cache is None:
        out = _self_attn(q, k, v)
    elif x.shape[1] > 1:
        out = _self_attn(q, k, v)
        cache = _cache_write_prefill(cache, k, v, kind, cfg)
    else:
        cache = _cache_write_step(cache, k, v, kind, cfg)
        # attention.py:197-198 shard(cache.k / cache.v, "cache_batch",
        # "kv_seq", None, None)
        ck = shard(cache.k, "cache_batch", "kv_seq", None, None)
        cv = shard(cache.v, "cache_batch", "kv_seq", None, None)
        valid = _decode_mask(cache, kind, cfg)       # [1, clen]
        b = x.shape[0]
        if cfg.use_pallas:
            out = ops.decode_attn(
                q[:, 0], ck, cv, valid.expand(b, valid.shape[-1]),
                softcap=cfg.softcap_attn, scale=_scale(cfg))[:, None]
        else:
            mask = valid[:, None, :].expand(b, 1, valid.shape[-1])
            out = _on_heads(lambda a, b_, c, m: _mha(a, b_, c, cfg, m),
                            q, ck, cv, mask)
    # attention.py:211 shard(out, "batch", "seq", "act_heads", None)
    out = shard(out, "batch", "seq", "act_heads", None)
    return _out_proj(out, p["wo"].to(x.dtype)), cache


# Ring-buffer invariant: the K/V of the token at absolute position ``a``
# lives at slot ``a % clen``.  Prefill and decode both honour it, so a
# prefill of any length can be continued by single-token decode steps.

def _in_place(write, ck, cv, *args):
    """``write(ck, cv, *args)``, which writes the cache tensors in place
    and returns them: under a mesh on each rank's shards, the writes'
    operands laid out as the cache is (DTensor has no in-place rule for
    these index writes), so the returned DTensors share the cache's
    storage."""
    if ambient_mesh() is None:
        return write(ck, cv, *args)
    pl = placements_of(ck)
    rep = [placements_of(a, free=range(a.dim())) for a in args[2:]]
    return on_shards(write, (ck, cv) + args, [pl] * 4 + rep, (pl, pl))


def _write_prefill(ck, cv, k, v, local: bool):
    t, clen = k.shape[1], ck.shape[1]
    if local and t > clen:
        slots = (t - clen + torch.arange(clen, device=k.device)) % clen
        ck[:, slots] = k[:, -clen:]                  # last `window` tokens
        cv[:, slots] = v[:, -clen:]
    else:
        ck[:, :t] = k
        cv[:, :t] = v
    return ck, cv


def _cache_write_prefill(cache: KVCache, k, v, kind: str,
                         cfg: ModelConfig) -> KVCache:
    t = k.shape[1]
    clen = cache.k.shape[1]
    local = kind in LOCAL_KINDS
    if not local and t > clen:
        raise ValueError(f"prefill of {t} tokens overflows a cache of "
                         f"{clen} slots (max_len)")
    ck, cv = _in_place(lambda a, b_, kk, vv: _write_prefill(a, b_, kk, vv,
                                                            local),
                       cache.k, cache.v, k, v)
    return KVCache(k=ck, v=cv, pos=cache.pos + t)


def _write_step(ck, cv, k, v, slot):
    ck.index_copy_(1, slot, k)
    cv.index_copy_(1, slot, v)
    return ck, cv


def _cache_write_step(cache: KVCache, k, v, kind: str,
                      cfg: ModelConfig) -> KVCache:
    """Write the token's K/V at its slot, chosen on the device from
    ``cache.pos`` (no host read)."""
    clen = cache.k.shape[1]
    if kind in LOCAL_KINDS:
        slot = cache.pos % clen
    else:
        slot = torch.clamp(cache.pos, max=clen - 1)
    slot = slot.reshape(1).long()
    ck, cv = _in_place(_write_step, cache.k, cache.v, k, v, slot)
    return KVCache(k=ck, v=cv, pos=cache.pos + 1)


def _decode_mask(cache: KVCache, kind: str, cfg: ModelConfig):
    """Valid-slot mask [1, clen]; cache.pos counts tokens incl. current."""
    clen = cache.k.shape[1]
    idx = torch.arange(clen, device=cache.k.device)
    if kind in LOCAL_KINDS:
        newest = (cache.pos - 1) % clen
        age = (newest - idx) % clen                  # 0 = newest
        valid = age < torch.clamp(cache.pos, max=clen)
    else:
        valid = idx < cache.pos
    return valid[None, :]


def cross_attention(p: dict, cfg: ModelConfig, x: torch.Tensor,
                    enc_kv: tuple[torch.Tensor, torch.Tensor]
                    ) -> torch.Tensor:
    """Decoder cross-attn over precomputed encoder K/V (whisper): plain
    ``_mha`` without a mask, as the reference's (no Pallas kernel)."""
    q = _proj(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    k, v = enc_kv
    out = _on_heads(lambda a, b_, c, m: _mha(a, b_, c, cfg, m), q, k, v,
                    None)
    return _out_proj(out, p["wo"].to(x.dtype))


def encode_kv(p: dict, cfg: ModelConfig, enc_out: torch.Tensor):
    """The encoder states' K and V [b, s, kv, hd] under ``p``'s
    projections (biases where ``p`` holds them)."""
    k, v = _proj(enc_out, p["wk"]), _proj(enc_out, p["wv"])
    if "bk" in p:
        k = k + p["bk"].to(enc_out.dtype)
        v = v + p["bv"].to(enc_out.dtype)
    return k, v
