"""mixtral-8x22b [moe] — 56L d6144 48H (GQA kv=8) expert d_ff 16384
vocab 32768, 8 experts top-2, SWA 4096 (per assignment).
[arXiv:2401.04088; hf]"""

from ..models.config import ModelConfig, MoEConfig
from .common import reduced

ARCH = "mixtral-8x22b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
        head_dim=128, d_ff=16384, vocab=32768,
        block_pattern=("moe_local",), window=4096,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=16384,
                      capacity_factor=1.25),
        rope_theta=1e6, mlp_kind="swiglu", norm_kind="rms",
        subquadratic=True,   # SWA bounds the KV cache
        # §Perf defaults: local sort dispatch over gathered tokens
        moe_impl="sort", moe_tokens="gathered")


def smoke_config() -> ModelConfig:
    return reduced(config(), n_layers=3, d_model=64, n_heads=4,
                   n_kv_heads=2, head_dim=16, d_ff=128, vocab=512,
                   window=16,
                   moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64,
                                 capacity_factor=8.0))
