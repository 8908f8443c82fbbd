"""repro_torch.ckpt — atomic checkpoints (port of ``repro.ckpt``), in
the reference's on-disk layout."""

from .checkpoint import (CheckpointManager, committed_steps,
                         load_checkpoint, save_checkpoint, latest_step)

__all__ = ["CheckpointManager", "committed_steps", "load_checkpoint",
           "save_checkpoint", "latest_step"]
