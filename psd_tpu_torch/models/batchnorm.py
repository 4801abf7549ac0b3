"""flax's `nn.BatchNorm` as a PyTorch module, for the metric backbones and
the classifier.

`nn.BatchNorm2d` differs from flax's in what the backbones' parity needs:
  * the names: flax keeps `scale` and `bias` in `params` and `mean` and
    `var` in `batch_stats`; here `weight` (the bridge's name for `scale`),
    `bias` and the buffers `mean` and `var`, so the bridge maps every leaf
    of both collections by name, and there is no `num_batches_tracked`;
  * the statistics: flax takes the batch variance as E[x²] − E[x]²
    (clipped at 0), the biased one, in float32, and updates the running
    statistics as `MOMENTUM · old + (1 − MOMENTUM) · batch` (flax
    momentum 0.9 is torch's 0.1); `nn.BatchNorm2d` keeps the unbiased
    variance;
  * the arithmetic: y = (x − mean) · (rsqrt(var + eps) · scale) + bias in
    float32, cast to the input's dtype.

In training mode (`module.train()`) the batch statistics normalize and the
running ones update in place; in eval mode the running ones normalize.
Input NCHW; the statistics are per channel.
"""

from __future__ import annotations

import torch
from torch import nn

MOMENTUM = 0.9  # flax's default, kept by every backbone of the repo


class BatchNorm(nn.Module):
    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    @torch.no_grad()
    def reset_flax_(self, generator: torch.Generator) -> None:
        """flax's init: scale 1, bias 0, running mean 0 and variance 1."""
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            with torch.no_grad():
                m = MOMENTUM
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)
