"""Training: optimizer and schedule, train state, train and eval steps."""

from .optim import build_optimizer, make_lr_schedule, weight_decay_mask
from .state import TrainState, optax_global_norm
from .step import (create_train_state, draw_drop_masks, make_eval_step,
                   make_loss_fn, make_train_step)

__all__ = ["TrainState", "build_optimizer", "create_train_state",
           "draw_drop_masks", "make_eval_step", "make_loss_fn",
           "make_lr_schedule", "make_train_step", "optax_global_norm",
           "weight_decay_mask"]
