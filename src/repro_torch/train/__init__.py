"""repro_torch.train — step builders + fault-tolerant training loop (port
of ``repro.train``; ``train_state_specs``, a mesh helper, is not
ported)."""

from .step import TrainState, make_train_step
from .loop import TrainLoopConfig, train_loop

__all__ = ["TrainState", "make_train_step", "TrainLoopConfig", "train_loop"]
