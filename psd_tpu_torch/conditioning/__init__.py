from .ordinal import AdditiveOrdinalEmbedder, interp_table
from .projection import ImageProjectionPlus
from .purifier import FeaturePurifier, MultiheadAttention

__all__ = [
    "AdditiveOrdinalEmbedder",
    "interp_table",
    "ImageProjectionPlus",
    "FeaturePurifier",
    "MultiheadAttention",
]
