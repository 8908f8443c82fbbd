"""Decoder-only LM trunk (port of ``repro.models.transformer``, for every
decoder-only block kind: ``attn``, ``local``, ``rec`` (RG-LRU), ``ssm``
(Mamba), ``moe_attn``, ``moe_local`` and the ``dense_attn`` head).

The reference stacks each period of ``cfg.block_pattern`` behind a
leading ``layers`` axis and scans over it; the port keeps the layers as
a flat list, in the reference's order (head, then every group's pattern
in turn, then tail), and runs them in a Python loop.
``convert.params_from_numpy`` unstacks a reference param tree into it.

Entry points:
  * param_defs(cfg)                          — ParamDef tree
  * forward(params, cfg, tokens, embeds=None) — (logits, MoE aux loss),
    as the reference's
  * prefill(params, cfg, tokens, max_len, caches=None, embeds=None)
                                             — last logits + caches
  * decode_step(params, cfg, token, caches, pos) — one-token serve step
    (``pos`` a [] int32 tensor, as in the reference)
  * init_caches(cfg, batch, max_len, dtype, device)
  * forward_hidden(params, cfg, tokens, embeds=None) — the trunk's output
    before the LM head, and the MoE aux loss
  * loss_fn(params, cfg, tokens, labels, embeds=None) — next-token
    cross-entropy (labels -1 ignored) + MoE aux: ``(loss + aux, (loss,
    aux))``, the head streamed over ``cfg.loss_chunk`` positions at a time

Training (``caches=None`` under autograd) checkpoints each layer by
``cfg.remat`` (``_remat``): ``"full"`` keeps a layer's inputs and
recomputes the rest in the backward, ``"dots"`` keeps the outputs of
its matrix products (JAX's ``checkpoint_dots_with_no_batch_dims``).
Either gives the same bits as ``"none"``.

A layer's cache is a ``KVCache`` (attention kinds), an ``SSMState``
(``ssm``) or an ``RGLRUState`` (``rec``), batch on axis 0 of every
tensor but ``KVCache.pos``.  Given caches are written in place: the K/V
rows by the attention, a recurrent layer's new state copied into the
caller's state tensors, so a captured decode step reads and writes the
same storage at every replay.  ``embeds=`` (``[b, t, d_model]``) takes
the place of the token embedding: the VLM (``models/vlm.py``) runs its
fused patch and token sequence through this trunk.  An encoder-decoder
config gets the trunk's defs from ``param_defs``, as in the reference
(``ModelConfig.param_count`` counts them); its model is
``models/encdec.py``.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch.utils import checkpoint as ckpt

from . import attention as attn_mod
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import ssm as ssm_mod
from ..dist.sharding import shard
from .config import ModelConfig
from .layers import (apply_logits, apply_mlp, apply_norm, embed_defs,
                     embed_lookup, logits_defs, masked_ce, mlp_defs,
                     norm_defs)

#: the block kinds this port runs
ATTN_KINDS = ("attn", "local", "moe_attn", "moe_local", "dense_attn")
PORTED_KINDS = ATTN_KINDS + ("rec", "ssm")


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
    """Raise ``ValueError`` for a block kind this port does not know."""
    for kind in sorted(set(layer_kinds(cfg))):
        if kind not in PORTED_KINDS:
            raise ValueError(f"{cfg.name}: unknown block kind {kind!r}")


def _block_defs(cfg: ModelConfig, kind: str) -> dict:
    nk, d = cfg.norm_kind, cfg.d_model
    if kind == "ssm":
        defs: dict[str, Any] = {"norm": norm_defs(nk, d),
                                "ssm": ssm_mod.ssm_defs(cfg)}
        if cfg.post_block_norm:
            defs["post1"] = norm_defs(nk, d)
        return defs
    defs = {"norm1": norm_defs(nk, d), "norm2": norm_defs(nk, d)}
    if kind == "rec":
        defs["rglru"] = rglru_mod.rglru_defs(cfg)
    else:
        defs["attn"] = attn_mod.attn_defs(cfg)
    if kind in ("moe_attn", "moe_local"):
        defs["moe"] = moe_mod.moe_defs(cfg)
    elif kind == "dense_attn":
        defs["mlp"] = mlp_defs(d, cfg.moe.d_ff_dense, cfg.mlp_kind)
    else:
        defs["mlp"] = mlp_defs(d, cfg.d_ff, cfg.mlp_kind)
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


def _blk_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
               dtype, device):
    if kind == "ssm":
        return ssm_mod.init_ssm_state(cfg, batch, dtype, device)
    if kind == "rec":
        return rglru_mod.init_rglru_state(cfg, batch, dtype, device)
    return attn_mod.init_cache(cfg, batch, max_len, kind, dtype, device)


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype,
                device) -> list:
    """One cache per layer (``KVCache``, ``SSMState`` or
    ``RGLRUState``), batch on axis 0."""
    check_ported(cfg)
    return [_blk_cache(cfg, k, batch, max_len, dtype, device)
            for k in layer_kinds(cfg)]


def _blk_cache_spec(cfg: ModelConfig, kind: str, batch: int, max_len: int):
    if kind == "ssm":
        return ssm_mod.ssm_state_spec(cfg)
    if kind == "rec":
        return rglru_mod.rglru_state_spec(cfg)
    return attn_mod.cache_spec(cfg, batch, max_len, kind)


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> list:
    """Logical dims of ``init_caches``'s caches: one ``KVCache``,
    ``SSMState`` or ``RGLRUState`` of dims tuples a layer (the
    reference's tree, unstacked as the port's caches are)."""
    check_ported(cfg)
    return [_blk_cache_spec(cfg, k, batch, max_len)
            for k in layer_kinds(cfg)]


def _keep_state(cache, new):
    """Write a recurrent layer's new state into the caller's tensors."""
    if cache is None:
        return None
    for old, val in zip(cache, new):
        old.copy_(val)
    return cache


def _apply_block(bp: dict, cfg: ModelConfig, kind: str, x, positions,
                 cache, aux):
    nk, eps = cfg.norm_kind, cfg.norm_eps
    if kind == "ssm":
        h, new = ssm_mod.apply_ssm(bp["ssm"], cfg,
                                   apply_norm(bp["norm"], x, nk, eps), cache)
        if cfg.post_block_norm:
            h = apply_norm(bp["post1"], h, nk, eps)
        return x + h, _keep_state(cache, new), aux

    h = apply_norm(bp["norm1"], x, nk, eps)
    if kind == "rec":
        h, new = rglru_mod.apply_rglru(bp["rglru"], cfg, h, cache)
        cache = _keep_state(cache, new)
    else:
        h, cache = attn_mod.attention(bp["attn"], cfg, kind, h, positions,
                                      cache)
    if cfg.post_block_norm:
        h = apply_norm(bp["post1"], h, nk, eps)
    x = x + h
    h = apply_norm(bp["norm2"], x, nk, eps)
    if kind in ("moe_attn", "moe_local"):
        h, a = moe_mod.apply_moe(bp["moe"], cfg, h)
        aux = aux + a
    else:
        h = apply_mlp(bp["mlp"], h, cfg.mlp_kind)
    if cfg.post_block_norm:
        h = apply_norm(bp["post2"], h, nk, eps)
    return x + h, cache, aux


_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Keep the outputs of products without batch dims (``x @ W``; the
    attention's batched einsums are ``bmm``), recompute the rest."""
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return ckpt.create_selective_checkpoint_contexts(_dots_policy)


def _remat(fn, cfg: ModelConfig):
    """``fn`` under the activation checkpointing ``cfg.remat`` names (the
    models draw no random numbers, so no RNG state is kept)."""
    if cfg.remat == "full":
        return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False,
                                          preserve_rng_state=False)
    if cfg.remat == "dots":
        return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False,
                                          preserve_rng_state=False,
                                          context_fn=_dots_context)
    return fn


def _trunk(params, cfg: ModelConfig, x, positions, caches):
    """Shared by forward/prefill/decode. caches=None for no cache.
    Returns (x, caches, MoE aux loss).  Without caches and under
    autograd, each layer runs under ``_remat``."""
    check_ported(cfg)
    kinds = layer_kinds(cfg)
    aux = torch.zeros((), device=x.device)
    new_caches = None if caches is None else []
    block = (_remat(_apply_block, cfg)
             if caches is None and torch.is_grad_enabled() else _apply_block)
    for i, kind in enumerate(kinds):
        x, c, aux = block(params["layers"][i], cfg, kind, x, positions,
                          None if caches is None else caches[i], aux)
        if caches is not None:
            new_caches.append(c)
    x = apply_norm(params["final_norm"], x, cfg.norm_kind, cfg.norm_eps)
    return x, new_caches, aux


def _positions(b: int, t: int, start: int, device) -> torch.Tensor:
    return (start + torch.arange(t, dtype=torch.int32, device=device)
            ).expand(b, t)


def _embed_in(params, cfg: ModelConfig, tokens, embeds):
    if embeds is not None:
        return embeds
    x = embed_lookup(params["embed"], tokens, cfg.embed_scale, cfg.d_model)
    # transformer.py:259 shard(x, "batch", "seq", "act_embed")
    return shard(x, "batch", "seq", "act_embed")


def forward(params, cfg: ModelConfig, tokens: Optional[torch.Tensor],
            embeds: Optional[torch.Tensor] = None):
    """tokens [b, t] -> (logits [b, t, vocab] float32, the MoE layers'
    summed aux loss, a [] float32 tensor), as the reference's (no
    cache).  ``embeds`` [b, t, d_model], when given, replaces the token
    embedding (``tokens`` is then unused)."""
    x = _embed_in(params, cfg, tokens, embeds)
    b, t = x.shape[:2]
    x, _, aux = _trunk(params, cfg, x, _positions(b, t, 0, x.device), None)
    return apply_logits(params["logits"], params["embed"], x,
                        cfg.tie_embeddings, cfg.softcap_final), aux


def prefill(params, cfg: ModelConfig, tokens: Optional[torch.Tensor],
            max_len: int, caches: Optional[list] = None,
            embeds: Optional[torch.Tensor] = None):
    """Prefill: fills caches, returns last-position logits + caches.

    ``caches`` (``init_caches(cfg, b, max_len, ...)``'s shapes) are
    zeroed and written in place instead of allocating a new set; the
    returned caches share their storage (a ``KVCache`` its ``k``/``v``, a
    recurrent state all of its tensors).  ``embeds`` as in ``forward``:
    positions run over its whole sequence, from 0."""
    x = _embed_in(params, cfg, tokens, embeds)
    b, t = x.shape[:2]
    if caches is None:
        caches = init_caches(cfg, b, max_len, x.dtype, x.device)
    else:
        for c in caches:
            for leaf in c:
                leaf.zero_()
    x, caches, _ = _trunk(params, cfg, x, _positions(b, t, 0, x.device),
                          caches)
    logits = apply_logits(params["logits"], params["embed"], x[:, -1:],
                          cfg.tie_embeddings, cfg.softcap_final)
    return logits, caches


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, caches,
                pos: torch.Tensor):
    """One serve step: token [b, 1], pos [] int32 (on the token's
    device) -> (logits [b, 1, vocab], caches).  The caches are updated
    in place (K/V rows, recurrent states); each returned ``KVCache``
    carries ``pos + 1``.  No host read, so the step can be captured as a
    CUDA graph."""
    x = _embed_in(params, cfg, token, None)
    b = x.shape[0]
    positions = pos.to(torch.int32).expand(b, 1)
    x, caches, _ = _trunk(params, cfg, x, positions, caches)
    logits = apply_logits(params["logits"], params["embed"], x,
                          cfg.tie_embeddings, cfg.softcap_final)
    return logits, caches


def forward_hidden(params, cfg: ModelConfig, tokens: Optional[torch.Tensor],
                   embeds: Optional[torch.Tensor] = None):
    """Trunk output before the LM head (for chunked-loss heads):
    (x [b, t, d_model], MoE aux loss)."""
    x = _embed_in(params, cfg, tokens, embeds)
    b, t = x.shape[:2]
    x, _, aux = _trunk(params, cfg, x, _positions(b, t, 0, x.device), None)
    return x, aux


def _head_ce(params, cfg: ModelConfig, x, labels):
    """The LM head and the cross-entropy sum (the reference's ``_ce``:
    ``layers.masked_ce``) over a stretch of positions."""
    logits = apply_logits(params["logits"], params["embed"], x,
                          cfg.tie_embeddings, cfg.softcap_final)
    return masked_ce(logits, labels)


def loss_fn(params, cfg: ModelConfig, tokens, labels,
            embeds: Optional[torch.Tensor] = None):
    """Next-token cross-entropy (labels = -1 ignored) + MoE aux:
    ``(loss + aux, (loss, aux))``.

    cfg.loss_chunk > 0 streams the LM head over sequence chunks, in the
    reference's order (the chunks, then the ragged tail), so the [b, t,
    vocab] logits tensor is never materialised: under autograd each
    chunk's head is checkpointed, so its logits are recomputed in the
    backward instead of kept."""
    if cfg.loss_chunk <= 0:
        logits, aux = forward(params, cfg, tokens, embeds)
        tot, cnt = masked_ce(logits, labels)
        loss = tot / torch.clamp_min(cnt, 1)
        return loss + aux, (loss, aux)

    x, aux = forward_hidden(params, cfg, tokens, embeds)
    t = x.shape[1]
    c = min(cfg.loss_chunk, t)
    nc = t // c
    bounds = [(i * c, (i + 1) * c) for i in range(nc)]
    if nc * c < t:   # ragged tail
        bounds.append((nc * c, t))
    tot = torch.zeros((), device=x.device)
    cnt = torch.zeros((), device=x.device)
    for lo, hi in bounds:
        xi, li = x[:, lo:hi], labels[:, lo:hi]
        if torch.is_grad_enabled():
            t_i, c_i = ckpt.checkpoint(_head_ce, params, cfg, xi, li,
                                       use_reentrant=False,
                                       preserve_rng_state=False)
        else:
            t_i, c_i = _head_ce(params, cfg, xi, li)
        tot, cnt = tot + t_i, cnt + c_i
    loss = tot / torch.clamp_min(cnt, 1)
    return loss + aux, (loss, aux)


def n_params(params) -> int:
    """Elements of a materialised param tree."""
    if isinstance(params, torch.Tensor):
        return params.numel()
    if isinstance(params, dict):
        return sum(n_params(v) for v in params.values())
    return sum(n_params(v) for v in params)


__all__ = ["ATTN_KINDS", "PORTED_KINDS", "cache_specs", "check_ported",
           "decode_step",
           "forward", "forward_hidden", "init_caches", "layer_kinds",
           "layer_plan", "loss_fn", "n_params", "param_defs", "prefill"]
