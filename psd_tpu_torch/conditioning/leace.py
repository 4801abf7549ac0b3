"""LEACE-style linear disease erasure: fit (numpy) and apply (torch).

The port's own copy of `psd_tpu/conditioning/leace.py`, which the port does
not import. Fit: flatten the (T·D) image tokens, take the between-class
scatter of the class-conditional means (rows weighted √n_k), SVD → the top
`rank` disease directions, null-space projection P = I − V_r V_rᵀ. Apply:
re-center around the training mean, project, add the mean back. The npz
format is psd_tpu's, so a file either package writes loads in the other.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def fit_leace(embeddings: np.ndarray, labels: np.ndarray, rank: int = 1) -> Dict:
    """(N, T, D) image tokens and (N,) labels → the projection dict, with
    `stats` (inter-class mean distances before and after, explained
    variance) as the self-check."""
    N, T, D = embeddings.shape
    X = embeddings.reshape(N, T * D).astype(np.float64)
    mu = X.mean(axis=0)
    Xc = X - mu

    means, counts = [], []
    for lbl in np.unique(labels):
        mask = labels == lbl
        means.append(Xc[mask].mean(axis=0))
        counts.append(int(mask.sum()))
    M = np.stack(means, axis=0)
    Mw = M * np.sqrt(np.asarray(counts, np.float64))[:, None]

    _, S, Vh = np.linalg.svd(Mw, full_matrices=False)
    mayo_dir = Vh[:rank].T  # (T·D, rank)
    P_null = np.eye(T * D) - mayo_dir @ mayo_dir.T

    def _max_pdist(A):
        return float(np.linalg.norm(A[:, None, :] - A[None, :, :], axis=-1).max())

    stats = {
        "dist_before": _max_pdist(M),
        "dist_after": _max_pdist(M @ P_null.T),
        "explained_variance": float((S[:rank] ** 2).sum() / (S ** 2).sum()),
    }
    return {
        "P_null": P_null.astype(np.float32),
        "mu": mu.astype(np.float32),
        "mayo_dir": mayo_dir.astype(np.float32),
        "rank": rank,
        "num_tokens": T,
        "token_dim": D,
        "stats": stats,
    }


def apply_leace(image_embeds: torch.Tensor, leace: Dict) -> torch.Tensor:
    """(B, T, D) → projected (B, T, D), in image_embeds' dtype and device."""
    B, T, D = image_embeds.shape
    P = torch.as_tensor(leace["P_null"]).to(image_embeds.device, image_embeds.dtype)
    mu = torch.as_tensor(leace["mu"]).to(image_embeds.device, image_embeds.dtype)
    clean = (image_embeds.reshape(B, T * D) - mu) @ P.T + mu
    return clean.reshape(B, T, D)


def save_leace(leace: Dict, path) -> None:
    np.savez(path, **{k: v for k, v in leace.items() if k != "stats"})


def load_leace(path) -> Dict:
    with np.load(path) as f:
        data = dict(f)
    for k in ("rank", "num_tokens", "token_dim"):
        data[k] = int(data[k])
    return data
