"""CLIP vision tower (ViT) with its projection, NHWC pixels in.

Counterpart of `psd_tpu/models/clip.py` (HF `CLIPVisionModelWithProjection`,
ViT-L/14 by default, QuickGELU):
  * `image_embeds(x)`      → pooled, projected embedding (B, projection_dim),
                             the plain ImageProjection's input;
  * `last_hidden_state(x)` → the last encoder layer's output
                             (B, num_positions, hidden), before
                             `post_layernorm`, as HF's `hidden_states[-1]`:
                             IP-Plus's input.
Module names are the flax tree names (`pre_layrnorm` with its typo,
`layers_{i}.q_proj`, ...), so the bridge (`convert/from_jax.py`) is the
mechanical walk. Each layer computes in the config's dtype with fp32
parameters cast at use (flax's dtype/param_dtype pair); LayerNorm takes
fp32 statistics. The attention is short (S = 257 at 224², 16 × 16 patches
and the class token), which neither psd_tpu's flash gate nor the port's
kernel routes take (S ≥ 512), so it runs the plain einsum path.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..ops.attention import dot_product_attention
from ..ops.geglu import ln_reference
from .layers import linear


@dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_dim: int = 4096
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @property
    def num_positions(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _ln(x, ln: nn.LayerNorm):
    """flax nn.LayerNorm(dtype=x.dtype): fp32 statistics and affine."""
    return ln_reference(x, ln.weight, ln.bias, ln.eps)


class CLIPEncoderLayer(nn.Module):
    """x + out_proj(MHA(LN1 x)) → x + fc2(quick_gelu(fc1(LN2 x)))."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        D, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.cfg = cfg
        self.layer_norm1 = nn.LayerNorm(D, eps=eps)
        self.q_proj = nn.Linear(D, D)
        self.k_proj = nn.Linear(D, D)
        self.v_proj = nn.Linear(D, D)
        self.out_proj = nn.Linear(D, D)
        self.layer_norm2 = nn.LayerNorm(D, eps=eps)
        self.fc1 = nn.Linear(D, cfg.mlp_dim)
        self.fc2 = nn.Linear(cfg.mlp_dim, D)

    def forward(self, x):
        c, dt = self.cfg, self.cfg.dtype
        B, S, D = x.shape
        h = _ln(x, self.layer_norm1)
        q, k, v = (linear(h, lyr, dt).reshape(B, S, c.num_heads, D // c.num_heads)
                   for lyr in (self.q_proj, self.k_proj, self.v_proj))
        x = x + linear(dot_product_attention(q, k, v).reshape(B, S, D), self.out_proj, dt)
        h = quick_gelu(linear(_ln(x, self.layer_norm2), self.fc1, dt))
        return x + linear(h, self.fc2, dt)


class CLIPVisionTower(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig = CLIPVisionConfig()):
        super().__init__()
        D, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.cfg = cfg
        self.class_embedding = nn.Parameter(torch.zeros(D))
        self.patch_embedding = nn.Conv2d(3, D, cfg.patch_size, stride=cfg.patch_size,
                                         bias=False)
        self.position_embedding = nn.Parameter(torch.zeros(cfg.num_positions, D))
        self.pre_layrnorm = nn.LayerNorm(D, eps=eps)
        for i in range(cfg.num_layers):
            self.add_module(f"layers_{i}", CLIPEncoderLayer(cfg))
        self.post_layernorm = nn.LayerNorm(D, eps=eps)
        self.visual_projection = nn.Linear(D, cfg.projection_dim, bias=False)

    @torch.no_grad()
    def reset_flax_(self, generator: torch.Generator):
        """The flax init of the free embeddings: N(0, 0.02)."""
        self.class_embedding.normal_(0.0, 0.02, generator=generator)
        self.position_embedding.normal_(0.0, 0.02, generator=generator)

    def _embed(self, pixel_values):
        """(B, H, W, 3) CLIP-preprocessed pixels → (B, num_positions, D)."""
        c, dt = self.cfg, self.cfg.dtype
        w = self.patch_embedding.weight.to(dt)
        patches = torch.nn.functional.conv2d(pixel_values.to(dt).permute(0, 3, 1, 2), w,
                                             stride=c.patch_size)
        B = patches.shape[0]
        patches = patches.flatten(2).transpose(1, 2)  # (B, h·w, D), row-major as NHWC
        cls = self.class_embedding.to(dt).expand(B, 1, -1)
        h = torch.cat([cls, patches], dim=1) + self.position_embedding.to(dt)[None]
        return _ln(h, self.pre_layrnorm)

    def last_hidden_state(self, pixel_values):
        h = self._embed(pixel_values)
        for i in range(self.cfg.num_layers):
            h = getattr(self, f"layers_{i}")(h)
        return h

    def image_embeds(self, pixel_values):
        h = self.last_hidden_state(pixel_values)
        pooled = _ln(h[:, 0, :], self.post_layernorm)
        return linear(pooled, self.visual_projection, self.cfg.dtype)

    def forward(self, pixel_values):
        return self.image_embeds(pixel_values)


def clip_vit_l14_config(**overrides) -> CLIPVisionConfig:
    """openai/clip-vit-large-patch14 (configs/train_ip.yaml `image_encoder_path`)."""
    return CLIPVisionConfig(**overrides)


def tiny_clip_config(**overrides) -> CLIPVisionConfig:
    """Small config for CPU tests (psd_tpu tiny_clip_config, fp32)."""
    base = dict(image_size=32, patch_size=8, hidden_size=32, num_layers=2, num_heads=2,
                mlp_dim=64, projection_dim=16, dtype=torch.float32)
    base.update(overrides)
    return CLIPVisionConfig(**base)
