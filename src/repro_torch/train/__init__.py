"""Training (port of :mod:`repro.train`): AdamW and the train step."""
from .optimizer import OptConfig, adamw_init, adamw_update, lr_schedule
from .train_loop import (TrainState, init_train_state, make_train_step,
                         train_state_axes)

__all__ = ["OptConfig", "adamw_init", "adamw_update", "lr_schedule",
           "TrainState", "init_train_state", "make_train_step",
           "train_state_axes"]
