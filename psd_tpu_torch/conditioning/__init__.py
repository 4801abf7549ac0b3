from .leace import apply_leace, fit_leace, load_leace, save_leace
from .ordinal import AdditiveOrdinalEmbedder, BasicOrdinalEmbedder, interp_table
from .projection import ImageProjection, ImageProjectionPlus
from .purifier import FeaturePurifier, MultiheadAttention

__all__ = [
    "AdditiveOrdinalEmbedder",
    "BasicOrdinalEmbedder",
    "interp_table",
    "ImageProjection",
    "ImageProjectionPlus",
    "FeaturePurifier",
    "MultiheadAttention",
    "apply_leace",
    "fit_leace",
    "load_leace",
    "save_leace",
]
