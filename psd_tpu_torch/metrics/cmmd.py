"""CMMD: the unbiased multi-bandwidth RBF MMD² between CLIP features.

Counterpart of `psd_tpu/metrics/cmmd.py`, in torch, float32, on the device
of its inputs (numpy inputs run on the CPU): features are the L2-normalized
CLIP ViT-L/14 projected embeddings; k(x, y) = exp(−‖x − y‖² / (2σ²)) for
σ ∈ {0.1, 1, 10, 100}, the diagonal-free unbiased estimator, summed over the
bandwidths. The squared distances are a2 + b2 − 2·a·bᵀ clamped at 0, as
psd_tpu's; their product runs in float32 (the port leaves
`torch.backends.cuda.matmul.allow_tf32` at its default, off).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

DEFAULT_SIGMAS = (0.1, 1.0, 10.0, 100.0)


def as_f32(x) -> torch.Tensor:
    """A numpy array or tensor → a float32 tensor (numpy on the CPU)."""
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x).float()


def l2_normalize(feats: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return feats / torch.clamp(torch.linalg.vector_norm(feats, dim=-1, keepdim=True), min=eps)


def sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, D), (M, D) → (N, M) squared Euclidean distances, clamped at 0."""
    a2 = (a * a).sum(dim=1)[:, None]
    b2 = (b * b).sum(dim=1)[None, :]
    return torch.clamp(a2 + b2 - 2.0 * (a @ b.T), min=0.0)


def mmd2_rbf(x, y, sigmas: Sequence[float] = DEFAULT_SIGMAS) -> torch.Tensor:
    """Unbiased multi-bandwidth MMD² between (N, D) and (M, D) features;
    −1 when either set has fewer than two."""
    x, y = as_f32(x), as_f32(y)
    n, m = x.shape[0], y.shape[0]
    if n < 2 or m < 2:
        return torch.tensor(-1.0)
    xx, yy, xy = sq_dists(x, x), sq_dists(y, y), sq_dists(x, y)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for sigma in sigmas:
        gamma = 1.0 / (2.0 * sigma ** 2)
        kxx, kyy, kxy = torch.exp(-gamma * xx), torch.exp(-gamma * yy), torch.exp(-gamma * xy)
        kxx_sum = (kxx.sum() - torch.trace(kxx)) / (n * (n - 1))
        kyy_sum = (kyy.sum() - torch.trace(kyy)) / (m * (m - 1))
        total = total + kxx_sum + kyy_sum - 2.0 * kxy.sum() / (n * m)
    return total


def compute_cmmd(real_feats, fake_feats, sigmas: Sequence[float] = DEFAULT_SIGMAS) -> float:
    """Features must be the L2-normalized CLIP projected embeddings."""
    return float(mmd2_rbf(real_feats, fake_feats, sigmas))
