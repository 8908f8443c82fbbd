"""repro_torch.models — every model family of the repo in PyTorch (port
of ``repro.models``: ``config``, ``layers``, ``attention``, ``moe``,
``rglru``, ``ssm``, ``transformer``, ``encdec`` and ``vlm``, with the
mesh helpers ``param_specs`` and ``abstract_params``)."""

from .config import (EncDecConfig, ModelConfig, MoEConfig, RGLRUConfig,
                     SSMConfig, VLMConfig)
from . import attention, encdec, layers, moe, rglru, ssm, transformer, vlm
from .layers import abstract_params, init_params, param_specs, param_shapes

__all__ = [
    "EncDecConfig", "ModelConfig", "MoEConfig", "RGLRUConfig", "SSMConfig",
    "VLMConfig", "attention", "encdec", "layers", "moe", "rglru", "ssm",
    "transformer", "vlm", "abstract_params", "init_params", "param_specs",
    "param_shapes",
]
