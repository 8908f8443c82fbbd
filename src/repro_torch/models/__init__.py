"""repro_torch.models — the decoder-only transformer substrate in PyTorch
(port of ``repro.models``: ``config``, ``layers``, ``attention`` and
``transformer`` for the block kinds ``attn`` and ``local``)."""

from .config import (EncDecConfig, ModelConfig, MoEConfig, RGLRUConfig,
                     SSMConfig, VLMConfig)
from . import attention, layers, transformer
from .layers import init_params

__all__ = [
    "EncDecConfig", "ModelConfig", "MoEConfig", "RGLRUConfig", "SSMConfig",
    "VLMConfig", "attention", "layers", "transformer", "init_params",
]
