"""Whisper-style encoder-decoder (port of ``repro.models.encdec``).  The
conv audio frontend is a STUB, as in the reference:
``configs.common.input_specs`` gives the shape of the precomputed frame
embeddings [b, enc_seq, d_model] (what the two conv layers would emit).

Decoder = causal self-attn + cross-attn + MLP per layer, LayerNorm,
learned positions.  Serving decodes with self-attn KV caches; each
layer's cross-attn K/V are recomputed from ``enc_out`` at every call, as
the reference does (``decode``).

Where the reference stacks each layer's params behind a leading
``layers`` axis (``params["enc"]``, ``params["dec"]``) and scans over it,
the port keeps flat lists and runs them in a Python loop
(``convert.params_from_numpy`` unstacks a reference tree).  Its decoder
caches are one ``KVCache`` a layer, each with its own [] int32 ``pos``
on the device (``init_dec_caches``); given caches are written in place,
so ``decode_step`` reads no host value and can be captured as a CUDA
graph.

One stated difference: ``decode`` indexes ``dec_pos`` (4096 rows) by
position.  The reference's ``jnp.take`` fills a row past the table with
NaN, but an out-of-range index on the card kills the CUDA context, so
``prefill`` raises ``ValueError`` on the host when ``max_len`` exceeds
the table (but for fake tensors, which hold no rows: the dry run traces
the reference's prefill_32k cell).

Entry points: ``param_defs``, ``encode``, ``decode``, ``forward``,
``prefill``, ``decode_step``, ``init_dec_caches``, ``dec_cache_specs``,
``loss_fn``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch._subclasses.fake_tensor import is_fake

from ..dist.sharding import shard
from . import attention as attn_mod
from .config import ModelConfig
from .layers import (ParamDef, apply_logits, apply_mlp, apply_norm,
                     embed_defs, embed_lookup, logits_defs, masked_nll,
                     mlp_defs, norm_defs)

#: rows of the learned decoder position table (the reference's 4096)
DEC_POS = 4096


def param_defs(cfg: ModelConfig) -> dict:
    e = cfg.encdec
    d, nk = cfg.d_model, cfg.norm_kind
    enc_block = {
        "norm1": norm_defs(nk, d),
        "attn": attn_mod.attn_defs(cfg),
        "norm2": norm_defs(nk, d),
        "mlp": mlp_defs(d, cfg.d_ff, cfg.mlp_kind),
    }
    dec_block = {
        "norm1": norm_defs(nk, d),
        "attn": attn_mod.attn_defs(cfg),
        "norm_x": norm_defs(nk, d),
        "xattn": attn_mod.attn_defs(cfg),
        "norm2": norm_defs(nk, d),
        "mlp": mlp_defs(d, cfg.d_ff, cfg.mlp_kind),
    }
    return {
        "enc_pos": ParamDef((e.enc_seq, d), (None, "embed"), "normal", 0.01),
        "enc": [enc_block] * e.n_enc_layers,
        "enc_norm": norm_defs(nk, d),
        "embed": embed_defs(cfg.vocab, d),
        "dec_pos": ParamDef((DEC_POS, d), (None, "embed"), "normal", 0.01),
        "dec": [dec_block] * cfg.n_layers,
        "final_norm": norm_defs(nk, d),
        "logits": logits_defs(cfg.vocab, d, cfg.tie_embeddings),
    }


def encode(params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames: [b, s, d] stub conv output -> encoder states (plain
    bidirectional attention, as the reference's ``_mha``)."""
    nk, eps = cfg.norm_kind, cfg.norm_eps
    s = frames.shape[1]
    x = frames + params["enc_pos"][:s][None].to(frames.dtype)
    # encdec.py:75 shard(x, "batch", "seq", "act_embed")
    x = shard(x, "batch", "seq", "act_embed")
    for bp in params["enc"]:
        h = apply_norm(bp["norm1"], x, nk, eps)
        q = attn_mod._proj(h, bp["attn"]["wq"])
        k, v = attn_mod.encode_kv(bp["attn"], cfg, h)
        if "bq" in bp["attn"]:
            q = q + bp["attn"]["bq"].to(h.dtype)
        out = attn_mod._on_heads(                     # bidirectional
            lambda a, b_, c, m: attn_mod._mha(a, b_, c, cfg, m), q, k, v,
            None)
        x = x + attn_mod._out_proj(out, bp["attn"]["wo"].to(h.dtype))
        x = x + apply_mlp(bp["mlp"], apply_norm(bp["norm2"], x, nk, eps),
                          cfg.mlp_kind)
    return apply_norm(params["enc_norm"], x, nk, eps)


def _dec_block(bp, cfg: ModelConfig, x, positions, cache, enc_kv):
    nk, eps = cfg.norm_kind, cfg.norm_eps
    h = apply_norm(bp["norm1"], x, nk, eps)
    h, cache = attn_mod.attention(bp["attn"], cfg, "attn", h, positions,
                                  cache, use_rope=False)
    x = x + h
    h = apply_norm(bp["norm_x"], x, nk, eps)
    x = x + attn_mod.cross_attention(bp["xattn"], cfg, h, enc_kv)
    h = apply_mlp(bp["mlp"], apply_norm(bp["norm2"], x, nk, eps),
                  cfg.mlp_kind)
    return x + h, cache


def decode(params, cfg: ModelConfig, tokens: torch.Tensor,
           enc_out: torch.Tensor, caches: Optional[list] = None,
           pos0: Optional[torch.Tensor] = None):
    """Teacher-forced decoding (caches=None) or a cached decode from
    position ``pos0`` (a [] int32 tensor; None = 0).  Returns (logits
    [b, t, vocab] float32, caches)."""
    nk, eps = cfg.norm_kind, cfg.norm_eps
    b, t = tokens.shape
    x = embed_lookup(params["embed"], tokens, cfg.embed_scale, cfg.d_model)
    posids = torch.arange(t, dtype=torch.int32, device=x.device)
    if pos0 is not None:
        posids = posids + pos0.to(torch.int32)
    x = x + params["dec_pos"][posids][None].to(x.dtype)
    positions = posids.expand(b, t)
    new_caches = None if caches is None else []
    for i, bp in enumerate(params["dec"]):
        enc_kv = attn_mod.encode_kv(bp["xattn"], cfg, enc_out)
        x, c = _dec_block(bp, cfg, x, positions,
                          None if caches is None else caches[i], enc_kv)
        if caches is not None:
            new_caches.append(c)
    x = apply_norm(params["final_norm"], x, nk, eps)
    logits = apply_logits(params["logits"], params["embed"], x,
                          cfg.tie_embeddings, cfg.softcap_final)
    return logits, new_caches


def init_dec_caches(cfg: ModelConfig, batch: int, max_len: int, dtype,
                    device) -> list:
    """One self-attn ``KVCache`` a decoder layer, each with its own []
    int32 ``pos`` on ``device``."""
    return [attn_mod.init_cache(cfg, batch, max_len, "attn", dtype, device)
            for _ in range(cfg.n_layers)]


def dec_cache_specs(cfg: ModelConfig) -> list:
    """Logical dims of ``init_dec_caches``'s caches, one a layer."""
    return [attn_mod.cache_spec(cfg, 0, 0, "attn")
            for _ in range(cfg.n_layers)]


def forward(params, cfg: ModelConfig, frames, tokens):
    """Full enc-dec training forward -> (logits, aux = 0)."""
    enc_out = encode(params, cfg, frames)
    logits, _ = decode(params, cfg, tokens, enc_out)
    return logits, torch.zeros((), dtype=torch.float32, device=logits.device)


def prefill(params, cfg: ModelConfig, frames, tokens, max_len: int,
            caches: Optional[list] = None):
    """Encode the audio and fill the decoder's self-attn caches over the
    prompt: (last-position logits, caches, enc_out).  ``caches``
    (``init_dec_caches``' shapes) are zeroed and rewritten in place
    instead of allocating a new set.  Raises ``ValueError`` when
    ``max_len`` is past the decoder's position table."""
    rows = params["dec_pos"].shape[0]
    # a trace on fake tensors (the dry run) reads no row
    if max_len > rows and not is_fake(tokens):
        raise ValueError(f"max_len {max_len} is past the decoder's "
                         f"{rows} learned positions (dec_pos)")
    enc_out = encode(params, cfg, frames)
    if caches is None:
        caches = init_dec_caches(cfg, tokens.shape[0], max_len,
                                 enc_out.dtype, enc_out.device)
    else:
        for c in caches:
            for leaf in c:
                leaf.zero_()
    logits, caches = decode(params, cfg, tokens, enc_out, caches)
    return logits[:, -1:], caches, enc_out


def decode_step(params, cfg: ModelConfig, token, enc_out, caches,
                pos: torch.Tensor):
    """One-token serve step: token [b, 1], ``pos`` a [] int32 tensor on
    the token's device -> (logits [b, 1, vocab], caches).  The caches'
    K/V are written in place (each returned ``KVCache`` carries
    ``pos + 1``); cross-attn re-reads ``enc_out``.  No host read."""
    return decode(params, cfg, token, enc_out, caches, pos0=pos)


def loss_fn(params, cfg: ModelConfig, frames, tokens, labels):
    """Next-token cross-entropy over ``labels`` (-1 ignored):
    (loss + aux, (loss, aux))."""
    logits, aux = forward(params, cfg, frames, tokens)
    loss = masked_nll(logits, labels)
    return loss + aux, (loss, aux)


__all__ = ["DEC_POS", "dec_cache_specs", "decode", "decode_step",
           "encode", "forward", "init_dec_caches", "loss_fn", "param_defs",
           "prefill"]
