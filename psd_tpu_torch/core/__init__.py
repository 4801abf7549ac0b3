from .config import (
    Config,
    DataConfig,
    DiffusionConfig,
    ModelConfig,
    OrdinalEmbedderConfig,
    TrainingConfig,
    apply_overrides,
    load_config,
)
from .mode import disable_kernels, eager, is_eager, is_training, kernel_disabled, training_mode

__all__ = [
    "Config",
    "DataConfig",
    "DiffusionConfig",
    "ModelConfig",
    "OrdinalEmbedderConfig",
    "TrainingConfig",
    "apply_overrides",
    "load_config",
    "disable_kernels",
    "eager",
    "is_eager",
    "is_training",
    "kernel_disabled",
    "training_mode",
]
