"""InternVL2-style VLM: ViT-stub -> MLP projector -> InternLM2 trunk
(port of ``repro.models.vlm``).

The InternViT frontend is a STUB, as in the reference:
``configs.common.input_specs`` gives the shape of the precomputed patch
embeddings [b, n_patches, vit_dim].  This module owns the projector
(vit_dim -> d_model) and splices the projected patches in front of the
token embeddings before running the decoder-only trunk of
``transformer.py`` over the fused sequence (positions 0..p+t-1).  A
decode after ``prefill`` is ``transformer.decode_step`` from position
``p + t``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import transformer
from ..dist.sharding import shard
from .config import ModelConfig
from .layers import (ParamDef, apply_norm, dot, embed_lookup, masked_nll,
                     norm_defs)


def param_defs(cfg: ModelConfig) -> dict:
    v = cfg.vlm
    defs = transformer.param_defs(cfg)
    defs["projector"] = {
        "norm": norm_defs("ln", v.vit_dim),
        "w1": ParamDef((v.vit_dim, cfg.d_model), ("fsdp", "tensor"),
                       "scaled"),
        "b1": ParamDef((cfg.d_model,), (None,), "zeros"),
        "w2": ParamDef((cfg.d_model, cfg.d_model), ("fsdp", "tensor"),
                       "scaled"),
        "b2": ParamDef((cfg.d_model,), (None,), "zeros"),
    }
    return defs


def project_patches(params, cfg: ModelConfig,
                    patches: torch.Tensor) -> torch.Tensor:
    """[b, p, vit_dim] -> [b, p, d_model] (LayerNorm whatever
    ``cfg.norm_kind`` is; GELU in its tanh form, ``jax.nn.gelu``'s)."""
    pp = params["projector"]
    x = apply_norm(pp["norm"], patches, "ln", cfg.norm_eps)
    x = dot(x, pp["w1"].to(x.dtype))
    x = F.gelu(x + pp["b1"].to(x.dtype), approximate="tanh")
    x = dot(x, pp["w2"].to(x.dtype))
    return x + pp["b2"].to(x.dtype)


def fuse_inputs(params, cfg: ModelConfig, patches, tokens) -> torch.Tensor:
    """Patch embeds ++ token embeds -> [b, p + t, d_model] in the token
    embedding's dtype."""
    img = project_patches(params, cfg, patches)
    txt = embed_lookup(params["embed"], tokens, cfg.embed_scale,
                       cfg.d_model)
    x = torch.cat([img.to(txt.dtype), txt], dim=1)
    # vlm.py:52 shard(x, "batch", "seq", "act_embed")
    return shard(x, "batch", "seq", "act_embed")


def forward(params, cfg: ModelConfig, patches, tokens):
    """-> (logits [b, p + t, vocab] float32, aux)."""
    embeds = fuse_inputs(params, cfg, patches, tokens)
    return transformer.forward(params, cfg, None, embeds=embeds)


def loss_fn(params, cfg: ModelConfig, patches, tokens, labels):
    """labels align with the fused sequence; patch positions use -1."""
    logits, aux = forward(params, cfg, patches, tokens)
    loss = masked_nll(logits, labels)
    return loss + aux, (loss, aux)


def prefill(params, cfg: ModelConfig, patches, tokens, max_len: int,
            caches: Optional[list] = None):
    """The fused sequence through ``transformer.prefill``: (last logits,
    caches); given ``caches`` are rewritten in place."""
    embeds = fuse_inputs(params, cfg, patches, tokens)
    return transformer.prefill(params, cfg, None, max_len, caches=caches,
                               embeds=embeds)


__all__ = ["forward", "fuse_inputs", "loss_fn", "param_defs", "prefill",
           "project_patches"]
