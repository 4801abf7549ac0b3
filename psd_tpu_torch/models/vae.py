"""AutoencoderKL (SD VAE), NHWC.

Counterpart of `psd_tpu/models/vae.py`. `VAEDecode` is the decode half
(`post_quant_conv` then `Decoder`), which a serving model holds;
`AutoencoderKL` adds the `Encoder` and `quant_conv` (images in [−1, 1] →
the diagonal Gaussian's mean and logvar), which training encodes its
batches with. The mid-block attention is single-head with D = C = 512 over
the latent's tokens (4096 at 512², 1024 at 256²); in `psd_tpu` it falls off
`spattn` (D > 256) onto the stock flash kernel, and here it takes the
attention kernel in its flash role. `VAEConfig.quant = "int8"` is the turbo
decoder: W8A8 resblock convs (`models/layers.py`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from ..ops.upconv import conv2d_nhwc
from .layers import ResnetBlock2D, Upsample2D, conv, final_conv, gn, linear


@dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_groups: int = 32
    # "int8": W8A8 convs in the decoder resblocks that the "vae" gate admits
    # (the mid block and the up-block resnets); conv_in, the upsamplers and
    # conv_out stay in dtype. Inference only (psd_tpu/models/vae.py:41-47).
    quant: str = "none"
    dtype: torch.dtype = torch.bfloat16


class VAEAttention(nn.Module):
    """Single-head spatial self-attention of the VAE mid block."""

    def __init__(self, channels: int, groups: int = 32, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.group_norm = nn.GroupNorm(groups, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out_0 = nn.Linear(channels, channels)

    def forward(self, x):
        dt = self.dtype
        B, H, W, C = x.shape
        h = gn(x, self.group_norm).reshape(B, H * W, C)
        q, k, v = (linear(h, lyr, dt)[:, :, None, :]
                   for lyr in (self.to_q, self.to_k, self.to_v))
        z = dot_product_attention(q, k, v)[:, :, 0, :]
        return x + linear(z, self.to_out_0, dt).reshape(B, H, W, C)


class VAEMidBlock(nn.Module):
    def __init__(self, channels: int, groups: int = 32, dtype=torch.bfloat16,
                 quant: str = "none"):
        super().__init__()
        kw = dict(eps=1e-6, groups=groups, dtype=dtype, quant=quant, quant_gate="vae")
        self.resnets_0 = ResnetBlock2D(channels, channels, **kw)
        self.attentions_0 = VAEAttention(channels, groups, dtype=dtype)
        self.resnets_1 = ResnetBlock2D(channels, channels, **kw)

    def forward(self, h):
        return self.resnets_1(self.attentions_0(self.resnets_0(h)))


class Encoder(nn.Module):
    """conv_in → down blocks (resnets, then a stride-2 conv after diffusers'
    asymmetric (0, 1) pad) → mid block → GN → SiLU → conv_out (2 × latent
    channels: mean and logvar)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.config = cfg
        dt, chs = cfg.dtype, cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, chs[0], 3, padding=1)
        h_ch = chs[0]
        for i, ch in enumerate(chs):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_blocks_{i}_resnets_{j}", ResnetBlock2D(
                    h_ch, ch, eps=1e-6, groups=cfg.norm_groups, dtype=dt))
                h_ch = ch
            if i < len(chs) - 1:
                self.add_module(f"down_blocks_{i}_downsamplers_0", nn.Conv2d(ch, ch, 3, stride=2))
        self.mid_block = VAEMidBlock(chs[-1], cfg.norm_groups, dtype=dt)
        self.conv_norm_out = nn.GroupNorm(cfg.norm_groups, chs[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(chs[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        cfg = self.config
        dt, m = cfg.dtype, self._modules
        n = len(cfg.block_out_channels)
        h = conv(x, self.conv_in, dt)
        for i in range(n):
            for j in range(cfg.layers_per_block):
                h = m[f"down_blocks_{i}_resnets_{j}"](h)
            if i < n - 1:
                down = m[f"down_blocks_{i}_downsamplers_0"]
                # (0, 1) on H and W, then a VALID stride-2 conv (psd_tpu/models/vae.py:113-116)
                h = conv2d_nhwc(F.pad(h.to(dt), (0, 0, 0, 1, 0, 1)), down.weight.to(dt),
                                down.bias.to(dt), stride=2, padding=0)
        h = F.silu(gn(self.mid_block(h), self.conv_norm_out))
        return final_conv(h, self.conv_out, dt)


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.config = cfg
        dt = cfg.dtype
        rev = tuple(reversed(cfg.block_out_channels))
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = VAEMidBlock(rev[0], cfg.norm_groups, dtype=dt, quant=cfg.quant)
        h_ch = rev[0]
        for i, ch in enumerate(rev):
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_blocks_{i}_resnets_{j}", ResnetBlock2D(
                    h_ch, ch, eps=1e-6, groups=cfg.norm_groups, dtype=dt, quant=cfg.quant,
                    quant_gate="vae"))
                h_ch = ch
            if i < len(rev) - 1:
                self.add_module(f"up_blocks_{i}_upsamplers_0", Upsample2D(ch, dtype=dt))
        self.conv_norm_out = nn.GroupNorm(cfg.norm_groups, rev[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z):
        cfg = self.config
        m = self._modules
        n = len(cfg.block_out_channels)
        h = self.mid_block(conv(z, self.conv_in, cfg.dtype))
        for i in range(n):
            for j in range(cfg.layers_per_block + 1):
                h = m[f"up_blocks_{i}_resnets_{j}"](h)
            if i < n - 1:
                h = m[f"up_blocks_{i}_upsamplers_0"](h)
        h = F.silu(gn(h, self.conv_norm_out))
        return final_conv(h, self.conv_out, cfg.dtype)


class VAEDecode(nn.Module):
    """The decode half of AutoencoderKL: z (B, h, w, 4) unscaled latents →
    (B, H, W, 3) fp32 images in about [-1, 1]."""

    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = cfg
        self.decoder = Decoder(cfg)
        self.post_quant_conv = nn.Conv2d(cfg.latent_channels, cfg.latent_channels, 1)

    def forward(self, z):
        # post_quant_conv runs in fp32, as in psd_tpu
        return self.decoder(conv(z.float(), self.post_quant_conv, torch.float32))


class AutoencoderKL(VAEDecode):
    """The whole VAE under psd_tpu's names (`encoder`, `quant_conv`,
    `decoder`, `post_quant_conv`): `encode` x (B, H, W, 3) in [−1, 1] →
    (mean, logvar), each (B, H/8, W/8, 4) fp32; calling it decodes, as
    `VAEDecode` does."""

    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__(cfg)
        self.encoder = Encoder(cfg)
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)

    def encode(self, x):
        # quant_conv runs in fp32, as in psd_tpu
        moments = conv(self.encoder(x).float(), self.quant_conv, torch.float32)
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)


def sample_gaussian(mean, logvar, noise):
    """A draw of the diagonal Gaussian from `noise` ~ N(0, 1) of mean's shape
    (the caller draws it; psd_tpu draws it from a key)."""
    return mean + torch.exp(0.5 * logvar) * noise


def sd_vae_config(**overrides) -> VAEConfig:
    return VAEConfig(**overrides)


def tiny_vae_config(**overrides) -> VAEConfig:
    base = dict(block_out_channels=(32, 64), layers_per_block=1, dtype=torch.float32)
    base.update(overrides)
    return VAEConfig(**base)
