"""GroupNorm as a per-(batch, channel) affine fold, NHWC.

Counterpart of `psd_tpu/ops/norms.py`: per-channel Σx and Σx² in fp32 over
the spatial axes, combined into group moments, then `x·w + b` applied in the
input dtype. `shift` folds the resblock's timestep-embedding addition into
the statistics, so GN(x + shift) never materializes x + shift. As in the
reference, the group variance E[x²]−μ² is not clamped.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def _affine_from_moments(s1, s2, n_per_group, scale, bias, G, eps):
    B, C = s1.shape
    g1 = s1.reshape(B, G, C // G).sum(-1)
    g2 = s2.reshape(B, G, C // G).sum(-1)
    mean_g = g1 / n_per_group
    var_g = g2 / n_per_group - mean_g**2
    inv_g = torch.reciprocal(torch.sqrt(var_g + eps))
    mean_c = mean_g.repeat_interleave(C // G, dim=-1)
    inv_c = inv_g.repeat_interleave(C // G, dim=-1)
    w = inv_c * scale.float()[None, :]
    b = bias.float()[None, :] - mean_c * w
    return w, b


def _moments(x):
    spatial = tuple(range(1, x.ndim - 1))
    xf = x.float()
    return xf.sum(spatial), (xf * xf).sum(spatial)


def group_norm_fold(x, scale, bias, num_groups: int = 32, eps: float = 1e-5,
                    shift: Optional[torch.Tensor] = None):
    """(w, b) fp32 (B, C) such that GN(x + shift)·scale + bias == x·w + b."""
    C = x.shape[-1]
    if C % num_groups:
        raise ValueError(f"channels {C} not divisible by groups {num_groups}")
    n_spatial = x.numel() // x.shape[0] // C
    s1, s2 = _moments(x)
    if shift is not None:
        t = shift.float()
        s2 = s2 + 2.0 * t * s1 + n_spatial * t * t
        s1 = s1 + n_spatial * t
    w, b = _affine_from_moments(s1, s2, n_spatial * (C // num_groups), scale, bias,
                                num_groups, eps)
    if shift is not None:
        b = b + w * shift.float()
    return w, b


def group_norm_fold_parts(parts: Sequence[torch.Tensor], scale, bias,
                          num_groups: int = 32, eps: float = 1e-5):
    """group_norm_fold over the channel concatenation of `parts`."""
    C = sum(p.shape[-1] for p in parts)
    if C % num_groups:
        raise ValueError(f"channels {C} not divisible by groups {num_groups}")
    moments = [_moments(p) for p in parts]
    s1 = torch.cat([m[0] for m in moments], dim=-1)
    s2 = torch.cat([m[1] for m in moments], dim=-1)
    n_spatial = parts[0].numel() // parts[0].shape[0] // parts[0].shape[-1]
    return _affine_from_moments(s1, s2, n_spatial * (C // num_groups), scale, bias,
                                num_groups, eps)


def apply_fold(x, w, b):
    """x·w + b with per-(batch, channel) w, b, in x's dtype."""
    shape = (w.shape[0],) + (1,) * (x.ndim - 2) + (w.shape[-1],)
    return x * w.to(x.dtype).reshape(shape) + b.to(x.dtype).reshape(shape)


def group_norm(x, scale, bias, num_groups: int = 32, eps: float = 1e-5,
               shift: Optional[torch.Tensor] = None):
    """GroupNorm of (B, H, W, C) or (B, S, C), output in x's dtype."""
    w, b = group_norm_fold(x, scale, bias, num_groups, eps, shift=shift)
    return apply_fold(x, w, b)
