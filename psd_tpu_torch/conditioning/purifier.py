"""Feature Purifier and the torch.nn.MultiheadAttention-style block it uses.

Counterpart of `psd_tpu/conditioning/purifier.py`:
  1. LN(image tokens), LN(source-AOE tokens);
  2. normalized image queries attend to the normalized AOE tokens → the
     disease component;
  3. a sigmoid gate MLP over concat(disease, normed image): 2D → D·ff → D;
  4. e_clean = image_embeds − gate ⊙ disease;
  5. LayerNorm out.
All fp32. The attention is short (16 queries), so it takes the plain einsum
path, as in JAX.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.attention import dot_product_attention
from ..ops.geglu import gelu_exact


def layer_norm(x, ln: nn.LayerNorm):
    """flax nn.LayerNorm: fast variance clamped at 0, (x−μ)·(rsqrt(var+ε)·scale) + bias."""
    mean = x.mean(-1, keepdim=True)
    var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    return (x - mean) * (torch.rsqrt(var + ln.eps) * ln.weight) + ln.bias


class MultiheadAttention(nn.Module):
    """Packed-projection multi-head attention with biases (batch first)."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, query, key, value):
        B, Sq, D = query.shape
        hd = D // self.num_heads
        q = self.q_proj(query).reshape(B, Sq, self.num_heads, hd)
        k = self.k_proj(key).reshape(B, -1, self.num_heads, hd)
        v = self.v_proj(value).reshape(B, -1, self.num_heads, hd)
        return self.out_proj(dot_product_attention(q, k, v).reshape(B, Sq, D))


class FeaturePurifier(nn.Module):
    def __init__(self, dim: int = 768, num_heads: int = 8, ff_mult: int = 2):
        super().__init__()
        self.norm_img = nn.LayerNorm(dim, eps=1e-5)
        self.norm_aoe = nn.LayerNorm(dim, eps=1e-5)
        self.cross_attn = MultiheadAttention(dim, num_heads)
        self.gate_0 = nn.Linear(2 * dim, dim * ff_mult)
        self.gate_2 = nn.Linear(dim * ff_mult, dim)
        self.norm_out = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, image_embeds, source_aoe):
        img_n = layer_norm(image_embeds, self.norm_img)
        aoe_n = layer_norm(source_aoe, self.norm_aoe)
        disease = self.cross_attn(img_n, aoe_n, aoe_n)
        g = self.gate_2(gelu_exact(self.gate_0(torch.cat([disease, img_n], dim=-1))))
        e_clean = image_embeds - torch.sigmoid(g) * disease
        return layer_norm(e_clean, self.norm_out)
