"""Training (port of ``sonicsim_tpu.train``), data-parallel over a mesh: the LR
controllers, the optax-exact train step in float32 and bf16, and the
``Trainer`` fit loop."""

from .schedulers import (CustomExponentialLR, DPTNetScheduler,
                         EarlyStopping, ReduceLROnPlateau)
from .trainer import (
    Trainer,
    TrainState,
    clip_by_global_norm,
    make_eval_step,
    make_optimizer,
    make_train_step,
    set_learning_rate,
)

__all__ = [
    "CustomExponentialLR",
    "DPTNetScheduler",
    "EarlyStopping",
    "ReduceLROnPlateau",
    "Trainer",
    "TrainState",
    "clip_by_global_norm",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
    "set_learning_rate",
]
