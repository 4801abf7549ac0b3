"""Improved Precision & Recall (Kynkäänniemi et al., arXiv:1904.06991).

Counterpart of `psd_tpu/metrics/prdc.py`, in torch, float32, on the device
of its inputs: each set's manifold is the union of balls whose radius is
the distance to the k-th nearest neighbour within the set (k = 3, self
excluded); precision is the share of fake samples inside the real manifold,
recall the share of real samples inside the fake one. Features are VGG16
fc7 (`models/vgg.py`). The radius is the (k+1)-th smallest squared
distance of each row (its self-distance 0 first): `torch.topk` may order
tied distances otherwise than `jax.lax.top_k`, but the value at that rank is
the same.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .cmmd import as_f32, sq_dists


def knn_radii(feats: torch.Tensor, k: int) -> torch.Tensor:
    """Distance of each row to its k-th nearest neighbour in the set."""
    d2 = sq_dists(feats, feats)
    kth = torch.topk(d2, k + 1, dim=1, largest=False, sorted=True).values[:, -1]
    return torch.sqrt(torch.clamp(kth, min=0.0))


def improved_precision_recall(real_feats, fake_feats, k: int = 3) -> Tuple[float, float]:
    """(precision, recall); (−1, −1) when either set has k or fewer."""
    real, fake = as_f32(real_feats), as_f32(fake_feats)
    if real.shape[0] < k + 1 or fake.shape[0] < k + 1:
        return -1.0, -1.0
    real_r, fake_r = knn_radii(real, k), knn_radii(fake, k)
    cross = torch.sqrt(sq_dists(fake, real))  # (M, N)
    precision = (cross <= real_r[None, :]).any(dim=1).float().mean()
    recall = (cross.T <= fake_r[None, :]).any(dim=1).float().mean()
    return float(precision), float(recall)
