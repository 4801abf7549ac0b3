"""Fréchet Inception Distance, in numpy (float64).

The port's copy of `psd_tpu/metrics/fid.py` (numpy, no JAX): the features'
mean and unbiased covariance, and the Fréchet distance between the two
Gaussians with tr(sqrtm(C1·C2)) taken as tr(sqrtm(S1·C2·S1)), S1 =
sqrtm(C1), both symmetric square roots by eigendecomposition.

FID = ||mu1 − mu2||² + tr(C1 + C2 − 2·sqrtm(C1·C2))
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def feature_stats(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) → (mu (D,), cov (D, D)) with unbiased covariance."""
    feats = np.asarray(feats, np.float64)
    mu = feats.mean(axis=0)
    cov = np.cov(feats, rowvar=False)
    return mu, cov


def _sqrtm_psd(mat: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    """Matrix square root via eigendecomposition (mat symmetrized)."""
    sym = (mat + mat.T) / 2.0
    vals, vecs = np.linalg.eigh(sym)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(
    mu1: np.ndarray, cov1: np.ndarray, mu2: np.ndarray, cov2: np.ndarray
) -> float:
    """Numerically robust Fréchet distance between two Gaussians.

    tr(sqrtm(C1·C2)) is computed as tr(sqrtm(S1 · C2 · S1)) with
    S1 = sqrtm(C1), which is PSD-symmetric and eigendecomposable — avoids
    scipy.linalg.sqrtm on a non-symmetric product.
    """
    diff = mu1 - mu2
    s1 = _sqrtm_psd(cov1)
    covmean = _sqrtm_psd(s1 @ cov2 @ s1)
    fid = float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2.0 * np.trace(covmean))
    return max(fid, 0.0)


def fid_from_features(real: np.ndarray, fake: np.ndarray) -> float:
    mu1, c1 = feature_stats(real)
    mu2, c2 = feature_stats(fake)
    return frechet_distance(mu1, c1, mu2, c2)
