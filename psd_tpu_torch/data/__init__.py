from .limuc import AugmentConfig, DataLoader, LIMUCDataset, PILAugment
from .preprocess import clip_preprocess

__all__ = ["AugmentConfig", "DataLoader", "LIMUCDataset", "PILAugment", "clip_preprocess"]
