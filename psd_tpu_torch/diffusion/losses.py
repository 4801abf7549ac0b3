"""Auxiliary losses.

Counterpart of `psd_tpu/diffusion/losses.py`: `orthogonal_loss` mean-pools
each token set and takes the squared cosine similarity of the pooled
vectors. As in psd_tpu, no training objective calls it.
"""

from __future__ import annotations

import torch


def orthogonal_loss(tokens_a: torch.Tensor, tokens_b: torch.Tensor,
                    eps: float = 1e-8) -> torch.Tensor:
    """(B, Na, D), (B, Nb, D) → scalar mean squared cosine similarity."""
    a = tokens_a.mean(dim=1)
    b = tokens_b.mean(dim=1)
    a = a / torch.clamp(torch.linalg.vector_norm(a, dim=-1, keepdim=True), min=eps)
    b = b / torch.clamp(torch.linalg.vector_norm(b, dim=-1, keepdim=True), min=eps)
    cos = torch.sum(a * b, dim=-1)
    return torch.mean(cos**2)
