"""Public attention wrappers the models call (port of the attention half
of ``repro.kernels.ops``).

They dispatch by device, as every wrapper of the port does: a CUDA
tensor launches the kernel, a CPU tensor runs its plain version.  There
is no fallback.  The plain attention on the card is the model's own
(``cfg.use_pallas=False``).
"""

from __future__ import annotations

from .decode_attention import decode_attention
from .flash_attention import flash_attention


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              softcap: float = 0.0, scale: float | None = None):
    """Fused attention: q [b, t, h, d], k/v [b, s, kv, d] -> [b, t, h, d]."""
    return flash_attention(q, k, v, causal=causal, window=window,
                           softcap=softcap, scale=scale)


def decode_attn(q, k, v, valid, *, softcap: float = 0.0,
                scale: float | None = None):
    """One query token: q [b, h, d], k/v [b, s, kv, d], valid [b, s]."""
    return decode_attention(q, k, v, valid, softcap=softcap, scale=scale)
