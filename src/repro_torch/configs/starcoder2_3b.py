"""starcoder2-3b [dense] — 30L d3072 24H (GQA kv=2) d_ff 12288 vocab 49152.
GQA, RoPE ~1e6, LayerNorm + GELU MLP, attention/MLP bias.
[arXiv:2402.19173; hf]"""

from ..models.config import ModelConfig
from .common import reduced

ARCH = "starcoder2-3b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2,
        head_dim=128, d_ff=12288, vocab=49152, qkv_bias=True,
        rope_theta=999999.44, mlp_kind="gelu", norm_kind="ln",
        norm_eps=1e-5, subquadratic=False)


def smoke_config() -> ModelConfig:
    return reduced(config(), n_layers=3, d_model=48, n_heads=6,
                   n_kv_heads=2, head_dim=8, d_ff=96, vocab=512)
