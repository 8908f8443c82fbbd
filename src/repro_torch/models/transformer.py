"""Decoder-only LM trunk (port of ``repro.models.transformer``, for the
block kinds ``attn`` and ``local``).

The reference stacks each period of ``cfg.block_pattern`` behind a
leading ``layers`` axis and scans over it; the port keeps the layers as
a flat list, in the reference's order (head, then every group's pattern
in turn, then tail), and runs them in a Python loop.
``convert.params_from_numpy`` unstacks a reference param tree into it.

Entry points:
  * param_defs(cfg)                          — ParamDef tree
  * forward(params, cfg, tokens)             — logits
  * prefill(params, cfg, tokens, max_len)    — last logits + caches
  * decode_step(params, cfg, token, caches, pos) — one-token serve step
    (``pos`` a [] int32 tensor, as in the reference)
  * init_caches(cfg, batch, max_len, dtype, device)

The other block kinds (``moe_*``, ``dense_attn``, ``ssm``, ``rec``) and
the encoder-decoder / VLM configs raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from . import attention as attn_mod
from .config import ModelConfig
from .layers import (apply_logits, apply_mlp, apply_norm, embed_defs,
                     embed_lookup, logits_defs, mlp_defs, norm_defs)

#: the block kinds this port runs
PORTED_KINDS = ("attn", "local")

_UNPORTED = ("not ported yet: ROADMAP Queue 1 item 3 (the MoE, SSM, "
             "RG-LRU, encoder-decoder and VLM models)")


def layer_plan(cfg: ModelConfig):
    """(head_kinds, pattern, n_groups, tail_kinds), as in the reference."""
    head = []
    if cfg.moe is not None and cfg.moe.first_k_dense:
        head = ["dense_attn"] * cfg.moe.first_k_dense
    remaining = cfg.n_layers - len(head)
    pat = tuple(cfg.block_pattern)
    if not cfg.scan_layers:
        return head + [pat[i % len(pat)] for i in range(remaining)], pat, 0, []
    n_groups = remaining // len(pat)
    tail_n = remaining - n_groups * len(pat)
    tail = [pat[i % len(pat)] for i in range(n_groups * len(pat),
                                             n_groups * len(pat) + tail_n)]
    return head, pat, n_groups, tail


def layer_kinds(cfg: ModelConfig) -> list[str]:
    """The kind of every layer, in the flat order the port runs them."""
    head, pat, n_groups, tail = layer_plan(cfg)
    return list(head) + list(pat) * n_groups + list(tail)


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this port does not run."""
    if cfg.encdec is not None:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder models are "
                                  + _UNPORTED)
    if cfg.vlm is not None:
        raise NotImplementedError(f"{cfg.name}: VLM models are " + _UNPORTED)
    for kind in sorted(set(layer_kinds(cfg))):
        if kind not in PORTED_KINDS:
            raise NotImplementedError(
                f"{cfg.name}: block kind {kind!r} is " + _UNPORTED)


def _block_defs(cfg: ModelConfig, kind: str) -> dict:
    nk, d = cfg.norm_kind, cfg.d_model
    defs: dict[str, Any] = {"norm1": norm_defs(nk, d),
                            "attn": attn_mod.attn_defs(cfg),
                            "norm2": norm_defs(nk, d),
                            "mlp": mlp_defs(d, cfg.d_ff, cfg.mlp_kind)}
    if cfg.post_block_norm:
        defs["post1"] = norm_defs(nk, d)
        defs["post2"] = norm_defs(nk, d)
    return defs


def param_defs(cfg: ModelConfig) -> dict:
    check_ported(cfg)
    return {"embed": embed_defs(cfg.vocab, cfg.d_model),
            "layers": [_block_defs(cfg, k) for k in layer_kinds(cfg)],
            "final_norm": norm_defs(cfg.norm_kind, cfg.d_model),
            "logits": logits_defs(cfg.vocab, cfg.d_model,
                                  cfg.tie_embeddings)}


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype,
                device) -> list:
    """One ``KVCache`` per layer, batch on axis 0."""
    check_ported(cfg)
    return [attn_mod.init_cache(cfg, batch, max_len, k, dtype, device)
            for k in layer_kinds(cfg)]


def _apply_block(bp: dict, cfg: ModelConfig, kind: str, x, positions,
                 cache):
    nk, eps = cfg.norm_kind, cfg.norm_eps
    h = apply_norm(bp["norm1"], x, nk, eps)
    h, cache = attn_mod.attention(bp["attn"], cfg, kind, h, positions, cache)
    if cfg.post_block_norm:
        h = apply_norm(bp["post1"], h, nk, eps)
    x = x + h
    h = apply_mlp(bp["mlp"], apply_norm(bp["norm2"], x, nk, eps),
                  cfg.mlp_kind)
    if cfg.post_block_norm:
        h = apply_norm(bp["post2"], h, nk, eps)
    return x + h, cache


def _trunk(params, cfg: ModelConfig, x, positions, caches):
    """Shared by forward/prefill/decode. caches=None for no cache."""
    check_ported(cfg)
    kinds = layer_kinds(cfg)
    new_caches = None if caches is None else []
    for i, kind in enumerate(kinds):
        x, c = _apply_block(params["layers"][i], cfg, kind, x, positions,
                            None if caches is None else caches[i])
        if caches is not None:
            new_caches.append(c)
    x = apply_norm(params["final_norm"], x, cfg.norm_kind, cfg.norm_eps)
    return x, new_caches


def _positions(b: int, t: int, start: int, device) -> torch.Tensor:
    return (start + torch.arange(t, dtype=torch.int32, device=device)
            ).expand(b, t)


def forward(params, cfg: ModelConfig, tokens: torch.Tensor):
    """tokens [b, t] -> logits [b, t, vocab] float32 (no cache)."""
    x = embed_lookup(params["embed"], tokens, cfg.embed_scale, cfg.d_model)
    b, t = x.shape[:2]
    x, _ = _trunk(params, cfg, x, _positions(b, t, 0, x.device), None)
    return apply_logits(params["logits"], params["embed"], x,
                        cfg.tie_embeddings, cfg.softcap_final)


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, max_len: int,
            caches: Optional[list] = None):
    """Prefill: fills caches, returns last-position logits + caches.

    ``caches`` (``init_caches(cfg, b, max_len, ...)``'s shapes) are
    zeroed and written in place instead of allocating a new set; the
    returned caches share their ``k``/``v`` storage."""
    x = embed_lookup(params["embed"], tokens, cfg.embed_scale, cfg.d_model)
    b, t = x.shape[:2]
    if caches is None:
        caches = init_caches(cfg, b, max_len, x.dtype, x.device)
    else:
        for c in caches:
            c.k.zero_()
            c.v.zero_()
            c.pos.zero_()
    x, caches = _trunk(params, cfg, x, _positions(b, t, 0, x.device),
                       caches)
    logits = apply_logits(params["logits"], params["embed"], x[:, -1:],
                          cfg.tie_embeddings, cfg.softcap_final)
    return logits, caches


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, caches,
                pos: torch.Tensor):
    """One serve step: token [b, 1], pos [] int32 (on the token's
    device) -> (logits [b, 1, vocab], caches).  The caches' ``k``/``v``
    are updated in place; each returned cache carries ``pos + 1``.  No
    host read, so the step can be captured as a CUDA graph."""
    x = embed_lookup(params["embed"], token, cfg.embed_scale, cfg.d_model)
    b = x.shape[0]
    positions = pos.to(torch.int32).expand(b, 1)
    x, caches = _trunk(params, cfg, x, positions, caches)
    logits = apply_logits(params["logits"], params["embed"], x,
                          cfg.tie_embeddings, cfg.softcap_final)
    return logits, caches


def n_params(params) -> int:
    """Elements of a materialised param tree."""
    if isinstance(params, torch.Tensor):
        return params.numel()
    if isinstance(params, dict):
        return sum(n_params(v) for v in params.values())
    return sum(n_params(v) for v in params)


__all__ = ["PORTED_KINDS", "check_ported", "decode_step", "forward",
           "init_caches", "layer_kinds", "layer_plan", "n_params",
           "param_defs", "prefill"]
