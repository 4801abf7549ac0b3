"""SD-v1.4-class conditional UNet (NHWC), with psd_tpu's forward phases.

Counterpart of `psd_tpu/models/unet.py`. Block roles follow the reference's
frequency strategy: low-resolution blocks (down index ≥ n−2, mid, up index
≤ 1) carry the "disease" gates, high-resolution blocks the "anatomy" gates.
`phase` splits the forward for encoder propagation (Faster Diffusion,
arXiv:2312.09608: "encode"/"decode") and DeepCache (arXiv:2310.01407:
"deep"/"shallow"), the turbo serving levers of `diffusion/sampler.py`.

`remat` is gradient checkpointing of every ResnetBlock2D and Transformer2D
(`psd_tpu/models/unet.py:176-178`, `training.gradient_checkpointing`):
`torch.utils.checkpoint` without re-entry, the kernel-mode flags of the
forward carried into the recomputation (`core.mode.snapshot`).
"""

from __future__ import annotations

from dataclasses import dataclass
import contextlib
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core import mode

from .layers import (
    CrossAttnMode,
    Downsample2D,
    ResnetBlock2D,
    TimestepEmbedding,
    Transformer2D,
    Upsample2D,
    conv,
    final_conv,
    gn,
    timestep_embedding,
)


PHASES = ("full", "encode", "decode", "deep", "shallow")


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    num_heads: int = 8
    cross_attention_dim: int = 768
    transformer_depth: int = 1
    attn_mode: str = "plain"  # "plain" | "split2" | "split3"
    num_aoe_tokens: int = 16
    num_image_tokens: int = 16
    num_delta_tokens: int = 16
    use_frequency_strategy: bool = True
    gate_init_anatomy: Tuple[float, float] = (0.5, 0.5)
    gate_init_disease: Tuple[float, float] = (0.5, 0.5)
    gate_init_both: Tuple[float, float] = (0.5, 0.5)
    remat: bool = False
    dtype: torch.dtype = torch.bfloat16

    def block_role(self, where: str, idx: int = 0) -> str:
        if not self.use_frequency_strategy:
            return "both"
        n = len(self.block_out_channels)
        if where == "mid":
            return "disease"
        if where == "down":
            return "disease" if idx >= n - 2 else "anatomy"
        if where == "up":
            return "disease" if idx <= 1 else "anatomy"
        return "both"

    def attn_mode_for(self, where: str, idx: int = 0) -> CrossAttnMode:
        gates = {
            "anatomy": self.gate_init_anatomy,
            "disease": self.gate_init_disease,
            "both": self.gate_init_both,
        }[self.block_role(where, idx)]
        if self.attn_mode == "split3":
            return CrossAttnMode(
                kind="split3",
                num_aoe_tokens=self.num_aoe_tokens,
                num_image_tokens=self.num_image_tokens,
                num_delta_tokens=self.num_delta_tokens,
                anat_gate=gates[0],
                dis_gate=gates[1],
            )
        if self.attn_mode == "split2":
            return CrossAttnMode(kind="split2", num_aoe_tokens=self.num_aoe_tokens,
                                 num_image_tokens=self.num_image_tokens)
        if self.attn_mode != "plain":
            raise ValueError(f"attn_mode {self.attn_mode!r} is not one of plain, split2, split3")
        return CrossAttnMode(kind="plain")

    @property
    def has_cross_attn(self) -> Tuple[bool, ...]:
        n = len(self.block_out_channels)
        return tuple(i < n - 1 for i in range(n))

    def transformer_sites(self, shallow: bool = False):
        """(module name, level, channels, cross-attention mode) of each
        Transformer2D, in the order a forward runs them; level i works at
        the latents' size / 2**i. `shallow`: those of DeepCache's shallow
        phase (down block 0 and the last up block). The model builds its
        Transformer2Ds from this list."""
        n, chans = len(self.block_out_channels), self.block_out_channels
        sites = []
        for i in ((0,) if shallow else range(n)):
            if self.has_cross_attn[i]:
                sites += [(f"down_blocks_{i}_attentions_{j}", i, chans[i],
                           self.attn_mode_for("down", i)) for j in range(self.layers_per_block)]
        if not shallow:
            sites.append(("mid_block_attentions_0", n - 1, chans[-1], self.attn_mode_for("mid")))
        rev_attn = tuple(reversed(self.has_cross_attn))
        for i in ((n - 1,) if shallow else range(n)):
            if rev_attn[i]:
                sites += [(f"up_blocks_{i}_attentions_{j}", n - 1 - i, chans[n - 1 - i],
                           self.attn_mode_for("up", i)) for j in range(self.layers_per_block + 1)]
        return sites


class UNet2DCondition(nn.Module):
    def __init__(self, config: UNetConfig):
        super().__init__()
        cfg = self.config = config
        dt = cfg.dtype
        ch0 = cfg.block_out_channels[0]
        temb_dim = ch0 * 4
        n = len(cfg.block_out_channels)

        sites = {name: (ch, m) for name, _, ch, m in cfg.transformer_sites()}

        def attn(name):
            if name in sites:
                ch, m = sites[name]
                self.add_module(name, Transformer2D(ch, cfg.num_heads, cfg.cross_attention_dim,
                                                    cfg.transformer_depth, m, dtype=dt))

        self.time_embedding = TimestepEmbedding(ch0, temb_dim, dtype=dt)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1)

        skip_ch = [ch0]
        h_ch = ch0
        for i, out_ch in enumerate(cfg.block_out_channels):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_blocks_{i}_resnets_{j}",
                                ResnetBlock2D(h_ch, out_ch, temb_dim, dtype=dt))
                h_ch = out_ch
                attn(f"down_blocks_{i}_attentions_{j}")
                skip_ch.append(out_ch)
            if i < n - 1:
                self.add_module(f"down_blocks_{i}_downsamplers_0",
                                Downsample2D(out_ch, dtype=dt))
                skip_ch.append(out_ch)

        mid = cfg.block_out_channels[-1]
        self.mid_block_resnets_0 = ResnetBlock2D(mid, mid, temb_dim, dtype=dt)
        attn("mid_block_attentions_0")
        self.mid_block_resnets_1 = ResnetBlock2D(mid, mid, temb_dim, dtype=dt)

        rev = tuple(reversed(cfg.block_out_channels))
        for i, out_ch in enumerate(rev):
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_blocks_{i}_resnets_{j}",
                                ResnetBlock2D(h_ch + skip_ch.pop(), out_ch, temb_dim, dtype=dt))
                h_ch = out_ch
                attn(f"up_blocks_{i}_attentions_{j}")
            if i < n - 1:
                self.add_module(f"up_blocks_{i}_upsamplers_0", Upsample2D(out_ch, dtype=dt))

        self.conv_norm_out = nn.GroupNorm(32, ch0, eps=1e-5)
        self.conv_out = nn.Conv2d(ch0, cfg.out_channels, 3, padding=1)

    def forward(self, sample, timesteps, encoder_hidden_states,
                delta_scale: Optional[float] = None, phase: str = "full", cached=None):
        """(B, H, W, C_in) latents, (B,) timesteps, (B, N, ctx) → fp32 eps.

        `phase` splits the forward as `psd_tpu/models/unet.py:137-155` does:
          "full"    — eps;
          "encode"  — down + mid only → (h_mid, skips);
          "decode"  — up + out from `cached` = (h_mid, skips) with a fresh
                      timestep embedding → eps; never touches `sample`;
          "deep"    — the full forward → (eps, the feature entering the
                      last up block), the DeepCache branch feature;
          "shallow" — conv_in → down block 0 (no downsampler) → the last up
                      block from `cached` (that feature) → out → eps."""
        if phase not in PHASES:
            raise ValueError(f"phase must be one of {PHASES}, got {phase!r}")
        if phase in ("decode", "shallow") and cached is None:
            raise ValueError(f"phase {phase!r} needs `cached`")
        cfg = self.config
        dt = cfg.dtype
        n = len(cfg.block_out_channels)
        m = {k: self._remat(v) for k, v in self._modules.items()}
        temb = self.time_embedding(
            timestep_embedding(timesteps, cfg.block_out_channels[0]).to(dt))
        ctx = encoder_hidden_states.to(dt)

        if phase == "decode":
            h, skips = cached
            h, skips = h.to(dt), [s.to(dt) for s in skips]
        else:
            h = conv(sample, self.conv_in, dt)
            skips = [h]
            # "shallow": down block 0 only; its downsampler output feeds
            # the deeper blocks, which the cached feature stands in for
            for i in ((0,) if phase == "shallow" else range(n)):
                for j in range(cfg.layers_per_block):
                    h = m[f"down_blocks_{i}_resnets_{j}"](h, temb)
                    if cfg.has_cross_attn[i]:
                        h = m[f"down_blocks_{i}_attentions_{j}"](h, ctx, delta_scale)
                    skips.append(h)
                if i < n - 1 and phase != "shallow":
                    h = m[f"down_blocks_{i}_downsamplers_0"](h)
                    skips.append(h)

            if phase != "shallow":
                h = m["mid_block_resnets_0"](h, temb)
                h = m["mid_block_attentions_0"](h, ctx, delta_scale)
                h = m["mid_block_resnets_1"](h, temb)
                if phase == "encode":
                    return h, tuple(skips)

        rev_attn = tuple(reversed(cfg.has_cross_attn))
        deep = None
        if phase == "shallow":
            h = cached.to(dt)
        for i in ((n - 1,) if phase == "shallow" else range(n)):
            if phase == "deep" and i == n - 1:
                deep = h
            for j in range(cfg.layers_per_block + 1):
                h = m[f"up_blocks_{i}_resnets_{j}"](h, temb, skips.pop())
                if rev_attn[i]:
                    h = m[f"up_blocks_{i}_attentions_{j}"](h, ctx, delta_scale)
            if i < n - 1:
                h = m[f"up_blocks_{i}_upsamplers_0"](h)

        h = F.silu(gn(h, self.conv_norm_out))
        eps = final_conv(h, self.conv_out, dt)
        return (eps, deep) if phase == "deep" else eps

    def _remat(self, module: nn.Module):
        """`module`, checkpointed when `remat` is set and gradients are on."""
        if not (self.config.remat and isinstance(module, (ResnetBlock2D, Transformer2D))):
            return module

        def run(*args):
            if not torch.is_grad_enabled():
                return module(*args)
            snap = mode.snapshot()
            return checkpoint(module, *args, use_reentrant=False,
                              context_fn=lambda: (contextlib.nullcontext(),
                                                  mode.restored(snap)))

        return run


def sd14_unet_config(**overrides) -> UNetConfig:
    """The SD v1.4 UNet (859,520,964 parameters in plain mode)."""
    return UNetConfig(**overrides)


def tiny_unet_config(**overrides) -> UNetConfig:
    """Small config for CPU tests (psd_tpu tiny_unet_config, fp32)."""
    base = dict(
        block_out_channels=(32, 64),
        layers_per_block=1,
        num_heads=2,
        cross_attention_dim=32,
        dtype=torch.float32,
    )
    base.update(overrides)
    return UNetConfig(**base)
