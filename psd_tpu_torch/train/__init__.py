from .checkpoint import CheckpointManager, load_weights, resolve_resume_path
from .ema import EMAState, ema_init, ema_update, swapped_in
from .optim import (
    Optimizer,
    OptState,
    build_optimizer,
    clip_by_global_norm_,
    global_norm,
    group_label,
    warmup_cosine_epochwise,
)
from .trainer import TrainState, create_train_state, make_train_step

__all__ = [
    "CheckpointManager",
    "load_weights",
    "resolve_resume_path",
    "EMAState",
    "ema_init",
    "ema_update",
    "swapped_in",
    "Optimizer",
    "OptState",
    "build_optimizer",
    "clip_by_global_norm_",
    "global_norm",
    "group_label",
    "warmup_cosine_epochwise",
    "TrainState",
    "create_train_state",
    "make_train_step",
]
