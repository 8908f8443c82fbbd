"""Shared shape table for all assigned archs (port of
``repro.configs.common``).

Every (arch x shape) cell is defined here once:
  * train_4k     seq 4,096   global_batch 256   -> train_step
  * prefill_32k  seq 32,768  global_batch 32    -> prefill
  * decode_32k   cache 32,768 global_batch 128  -> serve_step (1 token)
  * long_500k    cache 524,288 global_batch 1   -> serve_step (1 token)

``input_specs(cfg, shape)`` returns meta-device tensors (PyTorch's
counterpart of the reference's ``jax.ShapeDtypeStruct``): shapes and
dtypes only, no allocation, for full-size configs too.  The stub audio
frames and image patches are built from them.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    step: str                  # train | prefill | decode


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def supports(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """(runnable?, reason-if-skipped) per DESIGN.md §6."""
    cell = SHAPES[shape_name]
    if cell.step == "decode" and not cfg.supports_decode:
        return False, "encoder-only arch has no decode step"
    if shape_name == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention arch: 500k decode state is "
                       "O(seq) full KV with quadratic prefill — skipped "
                       "per assignment")
    return True, ""


I32 = torch.int32
BF16 = torch.bfloat16


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape_name: str) -> dict[str, Any]:
    """Meta-device stand-ins for every model input of this cell."""
    cell = SHAPES[shape_name]
    b, t = cell.global_batch, cell.seq_len
    S = _spec

    if cell.step == "train":
        if cfg.encdec is not None:
            return {
                "frames": S((b, cfg.encdec.enc_seq, cfg.d_model), BF16),
                "tokens": S((b, t), I32),
                "labels": S((b, t), I32),
            }
        if cfg.vlm is not None:
            p = cfg.vlm.n_patches
            return {
                "patches": S((b, p, cfg.vlm.vit_dim), BF16),
                "tokens": S((b, t - p), I32),
                "labels": S((b, t), I32),
            }
        return {"tokens": S((b, t), I32), "labels": S((b, t), I32)}

    if cell.step == "prefill":
        if cfg.encdec is not None:
            return {
                "frames": S((b, cfg.encdec.enc_seq, cfg.d_model), BF16),
                "tokens": S((b, t), I32),
            }
        if cfg.vlm is not None:
            p = cfg.vlm.n_patches
            return {
                "patches": S((b, p, cfg.vlm.vit_dim), BF16),
                "tokens": S((b, t - p), I32),
            }
        return {"tokens": S((b, t), I32)}

    # decode: one new token against a cache of length t
    return {"token": S((b, 1), I32)}


def decode_cache_len(shape_name: str) -> int:
    return SHAPES[shape_name].seq_len


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    return dataclasses.replace(cfg, **overrides)
