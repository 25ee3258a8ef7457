"""Training loop of the port (single device)."""

from repro_torch.training.train_step import (
    TrainConfig, TrainState, fused_lm_loss, init_train_state, make_train_step,
)
from repro_torch.training.trainer import RunConfig, Trainer

__all__ = ["TrainConfig", "TrainState", "make_train_step", "init_train_state",
           "fused_lm_loss", "Trainer", "RunConfig"]
