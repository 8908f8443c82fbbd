"""falcon-mamba-7b [ssm] — 64L d4096 attn-free, ssm_state 16, vocab 65024.
Mamba-1 blocks: in_proj -> conv1d(4) -> selective SSM -> gate -> out_proj,
d_inner 8192 (expand 2), dt_rank 256. [arXiv:2410.05355; unverified]"""

from ..models.config import ModelConfig, SSMConfig
from .common import reduced

ARCH = "falcon-mamba-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1,
        head_dim=64, d_ff=0, vocab=65024, block_pattern=("ssm",),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, dt_rank=256),
        norm_kind="rms", subquadratic=True,
        # §Perf defaults (EXPERIMENTS.md): channel-sharded chunked scan
        ssm_shard="channel", ssm_chunk=512)


def smoke_config() -> ModelConfig:
    return reduced(config(), n_layers=4, d_model=64, vocab=512,
                   ssm=SSMConfig(d_state=4, d_conv=4, expand=2, dt_rank=8))
