"""gemma2-27b [dense] — 46L d4608 32H (GQA kv=16) d_ff 36864 vocab 256000.
Local(4096)+global alternating, logit softcaps (attn 50, final 30),
post-block norms, GeGLU, tied embeddings, query scale 1/sqrt(144).
[arXiv:2408.00118; hf]"""

import math

from ..models.config import ModelConfig
from .common import reduced

ARCH = "gemma2-27b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16,
        head_dim=128, d_ff=36864, vocab=256000,
        block_pattern=("local", "attn"), window=4096,
        softcap_attn=50.0, softcap_final=30.0,
        query_scale=1.0 / math.sqrt(144.0),       # query_pre_attn_scalar
        mlp_kind="geglu", norm_kind="rms", post_block_norm=True,
        tie_embeddings=True, embed_scale=True,
        subquadratic=True)   # local layers ring-bounded; global = O(seq)/tok


def smoke_config() -> ModelConfig:
    return reduced(config(), n_layers=4, d_model=64, n_heads=4,
                   n_kv_heads=2, head_dim=16, d_ff=128, vocab=512,
                   window=16, query_scale=1.0 / math.sqrt(16.0))
