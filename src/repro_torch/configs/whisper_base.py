"""whisper-base [audio] — enc-dec 6+6L d512 8H d_ff 2048 vocab 51865.
Conv audio frontend is a STUB: input_specs feeds precomputed frame
embeddings [b, 1500, 512].  LayerNorm, GELU, biases, learned positions.
[arXiv:2212.04356; unverified]"""

from ..models.config import EncDecConfig, ModelConfig
from .common import reduced

ARCH = "whisper-base"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH, n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
        head_dim=64, d_ff=2048, vocab=51865, qkv_bias=True,
        mlp_kind="gelu", norm_kind="ln", norm_eps=1e-5,
        encdec=EncDecConfig(n_enc_layers=6, enc_seq=1500),
        subquadratic=False)


def smoke_config() -> ModelConfig:
    return reduced(config(), n_layers=2, d_model=64, n_heads=4,
                   n_kv_heads=4, head_dim=16, d_ff=128, vocab=512,
                   encdec=EncDecConfig(n_enc_layers=2, enc_seq=16))
