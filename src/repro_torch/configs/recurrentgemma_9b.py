"""recurrentgemma-9b [hybrid] — 38L d4096 16H (MQA kv=1) d_ff 12288
vocab 256000.  RG-LRU + local attention 1:2 (pattern rec,rec,local),
window 2048, GeGLU, tied + scaled embeddings. [arXiv:2402.19427]"""

from ..models.config import ModelConfig, RGLRUConfig
from .common import reduced

ARCH = "recurrentgemma-9b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
        head_dim=256, d_ff=12288, vocab=256000,
        block_pattern=("rec", "rec", "local"), window=2048,
        rglru=RGLRUConfig(lru_width=4096, conv_width=4),
        mlp_kind="geglu", norm_kind="rms", tie_embeddings=True,
        embed_scale=True, subquadratic=True)


def smoke_config() -> ModelConfig:
    return reduced(config(), n_layers=5, d_model=64, n_heads=4,
                   n_kv_heads=1, head_dim=16, d_ff=128, vocab=512,
                   window=16, rglru=RGLRUConfig(lru_width=64, conv_width=4))
