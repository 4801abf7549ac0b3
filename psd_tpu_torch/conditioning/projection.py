"""IP-Adapter image projections.

Counterpart of `psd_tpu/conditioning/projection.py`, fp32:
  * ImageProjection: Linear(clip_embedding_dim → D·N) → N tokens →
    LayerNorm(D), from CLIP's pooled `image_embeds`;
  * ImageProjectionPlus (Perceiver resampler): learnable latent queries,
    `depth` × {LN → MHA(q=latents, kv=patches) → residual, LN → FF(4×,
    GELU) → residual}, LayerNorm out, from CLIP's `last_hidden_state`. The
    key/value patches are not normalized.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.geglu import gelu_exact
from .purifier import MultiheadAttention, layer_norm


class ImageProjection(nn.Module):
    def __init__(self, clip_embedding_dim: int = 768, cross_attention_dim: int = 768,
                 num_tokens: int = 4):
        super().__init__()
        self.num_tokens, self.dim = num_tokens, cross_attention_dim
        self.projection = nn.Linear(clip_embedding_dim, cross_attention_dim * num_tokens)
        self.norm = nn.LayerNorm(cross_attention_dim, eps=1e-5)

    def forward(self, image_embeds):
        """(B, clip_embedding_dim) → (B, N, D)."""
        h = self.projection(image_embeds).reshape(-1, self.num_tokens, self.dim)
        return layer_norm(h, self.norm)


class ImageProjectionPlus(nn.Module):
    def __init__(self, clip_hidden_dim: int = 1024, cross_attention_dim: int = 768,
                 num_tokens: int = 16, num_heads: int = 8, depth: int = 2):
        super().__init__()
        D = cross_attention_dim
        self.depth = depth
        if clip_hidden_dim != D:
            self.proj_in = nn.Linear(clip_hidden_dim, D)
        self.latents = nn.Parameter(torch.zeros(1, num_tokens, D))
        for d in range(depth):
            self.add_module(f"layers_{d}_norm1", nn.LayerNorm(D, eps=1e-5))
            self.add_module(f"layers_{d}_cross_attn", MultiheadAttention(D, num_heads))
            self.add_module(f"layers_{d}_norm2", nn.LayerNorm(D, eps=1e-5))
            self.add_module(f"layers_{d}_ff_0", nn.Linear(D, 4 * D))
            self.add_module(f"layers_{d}_ff_2", nn.Linear(4 * D, D))
        self.norm_out = nn.LayerNorm(D, eps=1e-5)

    @torch.no_grad()
    def reset_flax_(self, generator: torch.Generator):
        self.latents.normal_(0.0, 0.02, generator=generator)

    def forward(self, hidden_states):
        """(B, num_patches+1, clip_hidden_dim) → (B, N, D)."""
        m = self._modules
        h = self.proj_in(hidden_states) if hasattr(self, "proj_in") else hidden_states
        latents = self.latents.expand(h.shape[0], -1, -1).to(h.dtype)
        for d in range(self.depth):
            normed = layer_norm(latents, m[f"layers_{d}_norm1"])
            latents = latents + m[f"layers_{d}_cross_attn"](normed, h, h)
            normed = layer_norm(latents, m[f"layers_{d}_norm2"])
            latents = latents + m[f"layers_{d}_ff_2"](gelu_exact(m[f"layers_{d}_ff_0"](normed)))
        return layer_norm(latents, self.norm_out)
