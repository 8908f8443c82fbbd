"""deepseek-moe-16b [moe] — 28L d2048 16H (MHA kv=16) vocab 102400.
Fine-grained MoE: 64 routed experts (d_ff 1408) top-6 + 2 shared experts,
first layer dense (d_ff 10944). [arXiv:2401.06066; hf]"""

from ..models.config import ModelConfig, MoEConfig
from .common import reduced

ARCH = "deepseek-moe-16b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
        head_dim=128, d_ff=1408, vocab=102400,
        block_pattern=("moe_attn",),
        moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408,
                      n_shared=2, d_ff_shared=2816, first_k_dense=1,
                      d_ff_dense=10944, capacity_factor=1.25),
        rope_theta=1e4, mlp_kind="swiglu", norm_kind="rms",
        subquadratic=False,
        # §Perf default: MHA kv=16 scores dominate collectives
        attn_impl="blockwise")


def smoke_config() -> ModelConfig:
    return reduced(config(), n_layers=3, d_model=64, n_heads=4,
                   n_kv_heads=4, head_dim=16, d_ff=32, vocab=512,
                   moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32,
                                 n_shared=2, d_ff_shared=64,
                                 first_k_dense=1, d_ff_dense=128,
                                 capacity_factor=8.0))
