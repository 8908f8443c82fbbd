"""internvl2-26b [vlm] — InternViT (STUB) + InternLM2-20B backbone:
48L d6144 48H (GQA kv=8) d_ff 16384 vocab 92553.  input_specs feeds
precomputed patch embeddings [b, 1024, 3200]. [arXiv:2404.16821; hf]"""

from ..models.config import ModelConfig, VLMConfig
from .common import reduced

ARCH = "internvl2-26b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
        head_dim=128, d_ff=16384, vocab=92553, rope_theta=1e6,
        mlp_kind="swiglu", norm_kind="rms",
        vlm=VLMConfig(n_patches=1024, vit_dim=3200),
        subquadratic=False)


def smoke_config() -> ModelConfig:
    return reduced(config(), n_layers=3, d_model=64, n_heads=4,
                   n_kv_heads=2, head_dim=16, d_ff=128, vocab=512,
                   vlm=VLMConfig(n_patches=8, vit_dim=48))
