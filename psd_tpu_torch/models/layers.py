"""UNet and VAE building blocks, NHWC, as PyTorch modules.

Counterpart of `psd_tpu/models/layers.py` (the ToMe-free path; of the int8
levers, the resblock's W8A8 convs that the int8 VAE decoder runs). Module attribute names are the flax tree names
(`time_emb_proj`, `attn2.to_k_dis`, `ff.net_0_proj`, ...), so the bridge from
JAX parameters (`convert/from_jax.py`) is a mechanical walk. Each module
computes in its `dtype`, casting parameters at use, as flax's (dtype,
param_dtype) pair does (`store_weights_in_` makes that cast a no-op for the
weights that are only ever used in `dtype`).

The five kernel sites, routed by shape as `psd_tpu` routes them:
  * self-attention with S ≥ 512 → `ops.attention` (the forward kernel; in
    training the FlashAttention autograd.Function with the backward kernel);
  * split3 cross-attention with S ≥ 256, S % 128 == 0 → `ops.split3`
    (in training its autograd.Function);
  * norm1/norm2 + q/k/v projections with B·S % 512 == 0, C % 64 == 0 →
    `ops.geglu.ln_proj_fwd` (inference only);
  * norm3 + GEGLU projection, same gate → `ops.geglu.ln_geglu_fwd`
    (inference only);
  * Transformer2D's GroupNorm → proj_in with S % 64 == 0, C % 64 == 0 →
    `ops.gnproj.gn_proj_fwd` (inference only).
Each wrapper runs its plain version for a CPU tensor.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.mode import is_training, use_kernel
from ..ops.attention import attention_probs, dot_product_attention
from ..ops.geglu import gelu_exact, ln_geglu_fwd, ln_proj_fwd, ln_reference
from ..ops.gnproj import gn_proj_fwd
from ..ops.norms import group_norm, group_norm_fold
from ..ops.quant import qconv3x3, quant_cols
from ..ops.split3 import split3_attention, split3_shape_error
from ..ops.upconv import conv2d_nhwc, upsample2x_conv3x3


@torch.no_grad()
def store_weights_in_(module: nn.Module, dtype) -> nn.Module:
    """Keep every Linear/Conv2d weight under `module` in `dtype`.

    The UNet's and the VAE decoder's matmul and conv weights are only ever
    consumed cast to the compute dtype, so storing them cast is the same
    math with one cast at load instead of one per use (≈780 cast kernels per
    SD-scale UNet eval). Biases and norm parameters stay fp32: the GroupNorm
    fold, LayerNorm, the GEGLU bias and the final conv bias use them in fp32."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            m.weight.data = m.weight.data.to(dtype)
    return module


def linear(x, layer: nn.Linear, dtype):
    """flax nn.Dense with (dtype, fp32 params): operands and bias in dtype."""
    b = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), b)


def conv(x, layer: nn.Conv2d, dtype, stride: int = 1):
    """NHWC conv with the layer's OIHW weight, SAME padding, in dtype."""
    pad = layer.kernel_size[0] // 2
    return conv2d_nhwc(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype),
                       stride=stride, padding=pad)


def conv1x1(x, layer: nn.Conv2d, dtype):
    """1×1 conv as a matmul over the last axis (Transformer2D proj_in/out)."""
    w = layer.weight.reshape(layer.out_channels, layer.in_channels)
    return F.linear(x.to(dtype), w.to(dtype), layer.bias.to(dtype))


def gn(x, layer: nn.GroupNorm, shift=None):
    return group_norm(x, layer.weight, layer.bias, layer.num_groups, layer.eps,
                      shift=shift)


def timestep_embedding(timesteps, dim: int, max_period: float = 10000.0,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0):
    """Sinusoidal timestep embedding, cos first (SD convention), fp32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                    device=timesteps.device)
    freqs = torch.exp(exponent / (half - downscale_freq_shift))
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """linear_1 → SiLU → linear_2."""

    def __init__(self, in_dim: int, time_embed_dim: int, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.linear_1 = nn.Linear(in_dim, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, t_emb):
        h = F.silu(linear(t_emb, self.linear_1, self.dtype))
        return linear(h, self.linear_2, self.dtype)


def final_conv(x, layer: nn.Conv2d, dtype):
    """3×3 conv in dtype, result upcast to fp32 before the fp32 bias
    (psd_tpu FinalConv: the UNet/VAE output convs)."""
    out = conv2d_nhwc(x.to(dtype), layer.weight.to(dtype), None, padding=1)
    return out.float() + layer.bias.float()


class ResnetBlock2D(nn.Module):
    """GN→SiLU→conv → (+temb folded into GN) → GN→SiLU→conv → +shortcut.

    The up path's skip join is a real channel concat here; `psd_tpu` splits
    the conv weights to avoid materializing it, which is the same math.

    `quant="int8"` (inference only) runs conv1 and conv2 as W8A8 `qconv3x3`
    where psd_tpu's `quant_gate="vae"` admits the input
    (psd_tpu/models/layers.py:145-167, :233-247): the SD decoder's win
    region, Cin ≥ 256 at ≤ 256², or Cin ≥ 128 with Cin == Cout. (The
    "unet" gate belongs to the UNet's int8 path, which is not ported.) The
    int8 weights and their per-Cout scales are buffers, set from the fp32
    weights by `quantize_int8_weights_`; on that branch norm2 runs without
    the temb fold and the embedding is added explicitly, as in psd_tpu."""

    def __init__(self, in_channels: int, out_channels: int, temb_dim: Optional[int] = None,
                 eps: float = 1e-5, groups: int = 32, dtype=torch.bfloat16,
                 quant: str = "none", quant_gate: str = "unet"):
        super().__init__()
        if quant not in ("none", "int8"):
            raise ValueError(f"quant must be 'none' or 'int8', got {quant!r}")
        if quant == "int8" and quant_gate != "vae":
            raise NotImplementedError(f"int8 quant_gate {quant_gate!r} is not ported")
        self.dtype = dtype
        self.quant = quant
        self.out_channels = out_channels
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=eps)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        if temb_dim is not None:
            self.time_emb_proj = nn.Linear(temb_dim, out_channels)
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=eps)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)
        if quant == "int8":
            for name, conv_ in (("conv1", self.conv1), ("conv2", self.conv2)):
                self.register_buffer(f"{name}_wq", torch.zeros(conv_.weight.shape, dtype=torch.int8),
                                     persistent=False)
                self.register_buffer(f"{name}_sw", torch.zeros(out_channels), persistent=False)

    def _q_conv_ok(self, x) -> bool:
        if self.quant != "int8" or is_training():
            return False
        cin, sp = x.shape[-1], max(x.shape[1], x.shape[2])
        return (cin >= 256 and sp <= 256) or (cin >= 128 and cin == self.out_channels)

    def forward(self, x, temb=None, skip=None):
        dt = self.dtype
        emb = None
        if hasattr(self, "time_emb_proj"):
            emb = linear(F.silu(temb), self.time_emb_proj, dt)
        if skip is not None:
            x = torch.cat([x, skip], dim=-1)
        if self._q_conv_ok(x):
            h = qconv3x3(F.silu(gn(x, self.norm1)).to(dt), self.conv1_wq, self.conv1_sw,
                         self.conv1.bias, out_dtype=dt)
            if emb is not None:
                h = h + emb[:, None, None, :].to(h.dtype)
            h = qconv3x3(F.silu(gn(h, self.norm2)).to(dt), self.conv2_wq, self.conv2_sw,
                         self.conv2.bias, out_dtype=dt)
        else:
            h = conv(F.silu(gn(x, self.norm1)), self.conv1, dt)
            # h + temb folds into norm2's statistics and affine (ops/norms.py)
            h = conv(F.silu(gn(h, self.norm2, shift=emb)), self.conv2, dt)
        if hasattr(self, "conv_shortcut"):
            x = conv(x, self.conv_shortcut, dt)
        return x + h


@torch.no_grad()
def quantize_int8_weights_(module: nn.Module, fp32_weights=None) -> nn.Module:
    """Set the int8 conv weights and per-Cout scales of every
    `ResnetBlock2D(quant="int8")` under `module` from fp32 weights: the
    module's own (before `store_weights_in_` casts them), or `fp32_weights`,
    a state_dict of fp32 tensors keyed as `module`'s (the bridge's). As
    psd_tpu quantizes the fp32 parameter tree (`ops/quant.py::quant_cols`)."""
    for prefix, m in module.named_modules():
        if not (isinstance(m, ResnetBlock2D) and m.quant == "int8"):
            continue
        for name in ("conv1", "conv2"):
            key = f"{prefix}.{name}.weight" if prefix else f"{name}.weight"
            w = getattr(m, name).weight if fp32_weights is None else fp32_weights[key]
            if w.dtype != torch.float32:
                raise ValueError(f"{key}: int8 weights come from fp32 values, got {w.dtype}")
            wq, sw = quant_cols(w.to(m.conv1_wq.device), axis=0)  # OIHW: Cout first
            getattr(m, f"{name}_wq").copy_(wq)
            getattr(m, f"{name}_sw").copy_(sw.reshape(-1))
    return module


class Downsample2D(nn.Module):
    def __init__(self, channels: int, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return conv(x, self.conv, self.dtype, stride=2)


class Upsample2D(nn.Module):
    def __init__(self, channels: int, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return upsample2x_conv3x3(x.to(self.dtype), self.conv.weight, self.conv.bias,
                                  dtype=self.dtype)


@dataclass(frozen=True)
class CrossAttnMode:
    """Static routing of one cross-attention site (psd_tpu CrossAttnMode).

    "plain": K/V over the whole conditioning sequence. "split2": the same
    K/V over [AOE | image] with fp32 probabilities before P·V (psd_tpu's
    post-softmax token rescale is left out: no config sets a factor other
    than 1, at which it is the identity). "split3": anat K/V from to_k/to_v over tokens
    [N_aoe : N_aoe+N_img]; dis and delta K/V from to_k_dis/to_v_dis over
    [:N_aoe] and [-N_delta:]; combined anat_gate·z_anat + dis_gate·z_dis +
    δ·z_delta.
    """

    kind: str = "plain"
    num_aoe_tokens: int = 16
    num_image_tokens: int = 16
    num_delta_tokens: int = 16
    anat_gate: float = 0.5
    dis_gate: float = 0.5


def ln_fused_ok(x) -> bool:
    """Shape gate of the fused LayerNorm kernels (layers.py:591-613)."""
    return (x.shape[0] * x.shape[1]) % 512 == 0 and x.shape[-1] % 64 == 0


def gn_proj_ok(S: int, C: int) -> bool:
    """Shape gate of the fused GroupNorm → proj_in kernel, any batch
    (psd_tpu/models/layers.py:570-583 on one device)."""
    return S % 64 == 0 and C % 64 == 0


def split3_kernel_ok(B: int, S: int, H: int, D: int, lens) -> bool:
    """Shape gate of the split3 kernel: psd_tpu's (S >= 256, S % 128 == 0;
    psd_tpu/models/layers.py:449) where the kernel admits q (B, S, H, D)
    with banks of `lens` tokens (`split3_shape_error`); a shape it refuses
    takes the plain path."""
    return S >= 256 and S % 128 == 0 and split3_shape_error(B, S, H, D, lens) is None


class Attention(nn.Module):
    """Multi-head attention; self-attention when `context` is None.

    The block's pre-attention LayerNorm is passed in (ln_scale/ln_bias) and
    fused with the projections: three (q, k, v) for self-attention, one (q)
    for cross-attention."""

    def __init__(self, dim: int, num_heads: int, context_dim: Optional[int] = None,
                 mode: CrossAttnMode = CrossAttnMode(), dtype=torch.bfloat16):
        super().__init__()
        if mode.kind not in ("plain", "split2", "split3"):
            raise ValueError(f"attention mode {mode.kind!r} is not one of plain, split2, split3")
        self.dtype = dtype
        self.num_heads = num_heads
        self.is_cross = context_dim is not None
        self.mode = mode if self.is_cross else CrossAttnMode("plain")
        ctx = context_dim if self.is_cross else dim
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(ctx, dim, bias=False)
        self.to_v = nn.Linear(ctx, dim, bias=False)
        if self.mode.kind == "split3":
            self.to_k_dis = nn.Linear(ctx, dim, bias=False)
            self.to_v_dis = nn.Linear(ctx, dim, bias=False)
        self.to_out_0 = nn.Linear(dim, dim)

    def forward(self, x, context=None, delta_scale: Optional[float] = None,
                ln_scale=None, ln_bias=None):
        dt = self.dtype
        B, S, C = x.shape
        hd = C // self.num_heads

        def heads(t):
            return t.reshape(B, -1, self.num_heads, hd)

        ws = (self.to_q.weight,) if self.is_cross else (
            self.to_q.weight, self.to_k.weight, self.to_v.weight)
        if ln_scale is None:
            outs = [F.linear(x.to(dt), w.to(dt)) for w in ws]
        elif ln_fused_ok(x) and use_kernel("ln_proj"):
            outs = ln_proj_fwd(x.reshape(B * S, C).to(dt), ln_scale, ln_bias,
                               tuple(w.to(dt) for w in ws))
            outs = [o.reshape(B, S, C) for o in outs]
        else:
            hn = ln_reference(x.to(dt), ln_scale, ln_bias)
            outs = [F.linear(hn, w.to(dt)) for w in ws]
        q = heads(outs[0])

        if not self.is_cross:
            z = dot_product_attention(q, heads(outs[1]), heads(outs[2]))
        elif self.mode.kind == "split3":
            m = self.mode
            ctx = context.to(dt)
            dis_tok = ctx[:, :m.num_aoe_tokens]
            anat_tok = ctx[:, m.num_aoe_tokens:m.num_aoe_tokens + m.num_image_tokens]
            delta_tok = ctx[:, ctx.shape[1] - m.num_delta_tokens:]
            banks = tuple(heads(linear(t, lyr, dt)) for t, lyr in (
                (anat_tok, self.to_k), (anat_tok, self.to_v),
                (dis_tok, self.to_k_dis), (dis_tok, self.to_v_dis),
                (delta_tok, self.to_k_dis), (delta_tok, self.to_v_dis)))
            ds = 0.0 if delta_scale is None else float(delta_scale)
            lens = [b.shape[1] for b in banks[0::2]]
            if split3_kernel_ok(B, S, self.num_heads, hd, lens) and use_kernel("split3"):
                z = split3_attention(q.contiguous(), *banks, ds, m.anat_gate, m.dis_gate)
            else:
                z_anat = dot_product_attention(q, banks[0], banks[1])
                z_dis = dot_product_attention(q, banks[2], banks[3])
                z_delta = dot_product_attention(q, banks[4], banks[5])
                z = m.anat_gate * z_anat + m.dis_gate * z_dis + ds * z_delta
        elif self.mode.kind == "split2":
            z = split2_attention(q, heads(linear(context, self.to_k, dt)),
                                 heads(linear(context, self.to_v, dt)))
        else:
            ctx = context.to(dt)
            z = dot_product_attention(q, heads(linear(ctx, self.to_k, dt)),
                                      heads(linear(ctx, self.to_v, dt)))
        return linear(z.reshape(B, S, C), self.to_out_0, dt)


def split2_attention(q, k, v):
    """The split2 site's attention (psd_tpu/models/layers.py:475-490 at its
    scales of 1): fp32 probabilities, then P·V with P cast to v's dtype."""
    return torch.einsum("bhqk,bkhd->bqhd", attention_probs(q, k).to(v.dtype), v)


class GEGLUFeedForward(nn.Module):
    """LN (passed in) → GEGLU projection dim→8·dim, split, h·gelu(g) →
    net_2 (4·dim→dim)."""

    def __init__(self, dim: int, mult: int = 4, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.net_0_proj = nn.Linear(dim, dim * mult * 2)
        self.net_2 = nn.Linear(dim * mult, dim)

    def forward(self, x, ln_scale, ln_bias):
        dt = self.dtype
        B, S, C = x.shape
        w0, b0 = self.net_0_proj.weight, self.net_0_proj.bias
        if ln_fused_ok(x) and use_kernel("ln_geglu"):
            h = ln_geglu_fwd(x.reshape(B * S, C).to(dt), ln_scale, ln_bias,
                             w0.to(dt), b0).reshape(B, S, -1)
        else:
            proj = F.linear(ln_reference(x.to(dt), ln_scale, ln_bias), w0.to(dt))
            hh, g = (proj.float() + b0.float()).chunk(2, dim=-1)
            h = (hh * gelu_exact(g)).to(dt)
        return linear(h, self.net_2, dt)


class BasicTransformerBlock(nn.Module):
    """x + attn1(LN1 x) → x + attn2(LN2 x, ctx) → x + FF(LN3 x)."""

    def __init__(self, dim: int, num_heads: int, context_dim: int,
                 mode: CrossAttnMode = CrossAttnMode(), dtype=torch.bfloat16):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, num_heads, dtype=dtype)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, num_heads, context_dim, mode, dtype=dtype)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = GEGLUFeedForward(dim, dtype=dtype)

    def forward(self, x, context, delta_scale=None):
        x = x + self.attn1(x, ln_scale=self.norm1.weight, ln_bias=self.norm1.bias)
        x = x + self.attn2(x, context, delta_scale, ln_scale=self.norm2.weight,
                           ln_bias=self.norm2.bias)
        return x + self.ff(x, self.norm3.weight, self.norm3.bias)


class Transformer2D(nn.Module):
    """GN → proj_in (1×1) → transformer block(s) → proj_out (1×1) → +x."""

    def __init__(self, channels: int, num_heads: int, context_dim: int, depth: int = 1,
                 mode: CrossAttnMode = CrossAttnMode(), dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.depth = depth
        self.norm = nn.GroupNorm(32, channels, eps=1e-6)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        for d in range(depth):
            self.add_module(f"transformer_blocks_{d}", BasicTransformerBlock(
                channels, num_heads, context_dim, mode, dtype=dtype))
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x, context, delta_scale=None):
        B, H, W, C = x.shape
        S = H * W
        if gn_proj_ok(S, C) and use_kernel("gn_proj"):
            # folded GroupNorm affine + proj_in as one kernel (layers.py:835-857)
            n = self.norm
            w, b = group_norm_fold(x, n.weight, n.bias, n.num_groups, n.eps)
            h = gn_proj_fwd(x.reshape(B, S, C).to(self.dtype), w, b,
                            self.proj_in.weight.reshape(C, C).to(self.dtype),
                            self.proj_in.bias)
        else:
            h = conv1x1(gn(x, self.norm), self.proj_in, self.dtype).reshape(B, S, C)
        for d in range(self.depth):
            h = getattr(self, f"transformer_blocks_{d}")(h, context, delta_scale)
        h = conv1x1(h.reshape(B, H, W, C), self.proj_out, self.dtype)
        return h + x
