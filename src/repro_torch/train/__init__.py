"""repro_torch.train — step builders + fault-tolerant training loop (port
of ``repro.train``)."""

from .step import TrainState, make_train_step, train_state_specs
from .loop import TrainLoopConfig, train_loop

__all__ = ["TrainState", "make_train_step", "train_state_specs",
           "TrainLoopConfig", "train_loop"]
