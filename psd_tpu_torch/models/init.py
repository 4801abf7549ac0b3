"""Seeded random initialisation that mirrors flax's initialisers.

`psd_tpu` initialises with flax defaults: `lecun_normal` (truncated normal in
±2σ, σ = sqrt(1/fan_in)/0.8796) for Dense and Conv kernels, zero biases,
unit norm scales. A seeded random SD-scale model here therefore has the same
activation statistics as the random-init model `bench.py` ran (the bits
differ: torch.Generator is not jax.random). Modules with their own init (the
ordinal embedder, the resampler latents) define `reset_flax_(generator)`.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# stddev of a standard normal truncated to ±2 (flax variance_scaling)
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator):
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    t.mul_(std)


@torch.no_grad()
def flax_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every parameter of `module` in place, as flax would."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            lecun_normal_(m.weight, m.in_features, generator)
        elif isinstance(m, nn.Conv2d):
            kh, kw = m.kernel_size
            lecun_normal_(m.weight, m.in_channels * kh * kw, generator)
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            m.weight.fill_(1.0)
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.LayerNorm, nn.GroupNorm)):
            if m.bias is not None:
                m.bias.zero_()
        if hasattr(m, "reset_flax_"):
            m.reset_flax_(generator)
    return module
