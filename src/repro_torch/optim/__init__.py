"""repro_torch.optim — AdamW, schedules, gradient clipping & compression
(port of ``repro.optim``; ``opt_state_specs``, a mesh helper, is not
ported)."""

from .adamw import (AdamWConfig, OptState, adamw_init, adamw_update,
                    global_norm, clip_by_global_norm)
from .schedule import cosine_schedule
from .compress import (compress_int8, decompress_int8, ef_compress_update,
                       EFState, ef_init)

__all__ = [
    "AdamWConfig", "OptState", "adamw_init", "adamw_update",
    "global_norm", "clip_by_global_norm",
    "cosine_schedule", "compress_int8", "decompress_int8",
    "ef_compress_update", "EFState", "ef_init",
]
