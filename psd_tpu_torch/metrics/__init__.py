from .classification import classification_report, regression_report
from .cmmd import compute_cmmd, l2_normalize, mmd2_rbf
from .fid import feature_stats, fid_from_features, frechet_distance
from .prdc import improved_precision_recall

__all__ = [
    "compute_cmmd", "l2_normalize", "mmd2_rbf",
    "feature_stats", "fid_from_features", "frechet_distance",
    "improved_precision_recall",
    "classification_report", "regression_report",
]
