"""phi3-medium-14b [dense] — 40L d5120 40H (GQA kv=10) d_ff 17920
vocab 100352.  RoPE, SwiGLU, RMSNorm. [arXiv:2404.14219; unverified]"""

from ..models.config import ModelConfig
from .common import reduced

ARCH = "phi3-medium-14b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10,
        head_dim=128, d_ff=17920, vocab=100352, rope_theta=1e4,
        mlp_kind="swiglu", norm_kind="rms", subquadratic=False)


def smoke_config() -> ModelConfig:
    return reduced(config(), n_layers=4, d_model=80, n_heads=8,
                   n_kv_heads=2, head_dim=10, d_ff=160, vocab=512)
