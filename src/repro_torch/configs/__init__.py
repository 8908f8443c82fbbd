"""repro_torch.configs — registry of the ten assigned architectures
(port of ``repro.configs``; the configs are plain data, copied).

``get_config(arch)`` / ``get_smoke_config(arch)`` / ``SHAPES`` are the
public surface; the serving launcher selects with ``--arch <id>``.
"""

from __future__ import annotations

from ..models.config import ModelConfig
from . import (deepseek_moe_16b, falcon_mamba_7b, gemma2_27b,
               internvl2_26b, mixtral_8x22b, phi3_medium_14b, qwen2_5_32b,
               recurrentgemma_9b, starcoder2_3b, whisper_base)
from .common import (SHAPES, ShapeCell, decode_cache_len, input_specs,
                     reduced, supports)

_MODULES = {
    m.ARCH: m for m in (
        qwen2_5_32b, starcoder2_3b, gemma2_27b, phi3_medium_14b,
        recurrentgemma_9b, whisper_base, falcon_mamba_7b, mixtral_8x22b,
        deepseek_moe_16b, internvl2_26b)
}

ARCHS = list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    return _MODULES[arch].config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _MODULES[arch].smoke_config()


def all_cells():
    """Every (arch, shape) pair with its runnability verdict."""
    out = []
    for a in ARCHS:
        cfg = get_config(a)
        for s in SHAPES:
            ok, why = supports(cfg, s)
            out.append((a, s, ok, why))
    return out


__all__ = ["ARCHS", "SHAPES", "ShapeCell", "all_cells", "decode_cache_len",
           "get_config", "get_smoke_config", "input_specs", "reduced",
           "supports"]
