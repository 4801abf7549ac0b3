"""Nearest-2× upsample followed by a 3×3 conv, NHWC.

Counterpart of `psd_tpu/ops/upconv.py`. The JAX package computes it as four
2×2 phase convolutions; this is its plain oracle
(`upsample2x_conv3x3_reference`): the same function, with the 4×-sized
upsampled tensor materialized. A phase-decomposed or fused version is queued
until the H100's own profile names it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d_nhwc(x, weight, bias=None, stride: int = 1, padding: int = 1):
    """Conv on an NHWC tensor with an OIHW weight; NHWC out. The permuted view
    is channels-last in memory, which cuDNN takes as it is."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def upsample2x_conv3x3(x, weight, bias=None, dtype=None):
    """= conv3x3_SAME(nearest_up2(x)) + bias, (B, H, W, Ci) → (B, 2H, 2W, Co)."""
    dtype = dtype or x.dtype
    up = x.to(dtype).repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    y = conv2d_nhwc(up, weight.to(dtype))
    if bias is not None:
        y = y.float() + bias.float()
    return y.to(dtype)
