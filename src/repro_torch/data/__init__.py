"""repro_torch.data — deterministic sharded token pipeline (port of
``repro.data``)."""

from .pipeline import DataConfig, SyntheticLM, make_batches

__all__ = ["DataConfig", "SyntheticLM", "make_batches"]
