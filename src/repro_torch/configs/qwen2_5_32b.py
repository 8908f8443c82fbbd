"""qwen2.5-32b [dense] — 64L d5120 40H (GQA kv=8) d_ff 27648 vocab 152064.
GQA + QKV bias, RoPE theta 1e6, SwiGLU, RMSNorm. [hf:Qwen/Qwen2.5; hf]"""

from ..models.config import ModelConfig
from .common import reduced

ARCH = "qwen2.5-32b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
        head_dim=128, d_ff=27648, vocab=152064, qkv_bias=True,
        rope_theta=1e6, mlp_kind="swiglu", norm_kind="rms",
        subquadratic=False)


def smoke_config() -> ModelConfig:
    return reduced(config(), n_layers=4, d_model=64, n_heads=8,
                   n_kv_heads=2, head_dim=8, d_ff=128, vocab=512)
