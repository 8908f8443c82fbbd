"""repro_torch.models — the decoder-only model families in PyTorch (port
of ``repro.models``: ``config``, ``layers``, ``attention``, ``moe``,
``rglru``, ``ssm`` and ``transformer``; ``encdec`` and ``vlm`` are not
ported yet)."""

from .config import (EncDecConfig, ModelConfig, MoEConfig, RGLRUConfig,
                     SSMConfig, VLMConfig)
from . import attention, layers, moe, rglru, ssm, transformer
from .layers import init_params, param_shapes

__all__ = [
    "EncDecConfig", "ModelConfig", "MoEConfig", "RGLRUConfig", "SSMConfig",
    "VLMConfig", "attention", "layers", "moe", "rglru", "ssm",
    "transformer", "init_params", "param_shapes",
]
