"""repro_torch.optim — AdamW, schedules, gradient clipping & compression
(port of ``repro.optim``)."""

from .adamw import (AdamWConfig, OptState, adamw_init, adamw_update,
                    opt_state_specs, global_norm, clip_by_global_norm)
from .schedule import cosine_schedule
from .compress import (compress_int8, decompress_int8, ef_compress_update,
                       EFState, ef_init)

__all__ = [
    "AdamWConfig", "OptState", "adamw_init", "adamw_update",
    "opt_state_specs", "global_norm", "clip_by_global_norm",
    "cosine_schedule", "compress_int8", "decompress_int8",
    "ef_compress_update", "EFState", "ef_init",
]
