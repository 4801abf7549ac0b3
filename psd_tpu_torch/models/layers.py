"""UNet and VAE building blocks, NHWC, as PyTorch modules.

Counterpart of `psd_tpu/models/layers.py`, with its two inference levers:
ToMe token merging in `BasicTransformerBlock` (`ops/tome.py`) and the W8A8
int8 path (`quant="int8"`: `qconv3x3` in the resblocks, `qdense` in the
attention projections, the GEGLU feed-forward and Transformer2D's 1×1
convs). Module attribute names are the flax tree names
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
  * norm1/norm2 + q/k/v projections with B·S % 128 == 0, C % 64 == 0 →
    `ops.geglu.ln_proj_fwd` (inference only; not where the int8 path
    projects, C ≥ 512);
  * norm3 + GEGLU projection, same gate → `ops.geglu.ln_geglu_fwd`
    (inference only; not where the int8 path projects, C ≥ 512);
  * Transformer2D's GroupNorm → proj_in with S % 64 == 0, C % 64 == 0 →
    `ops.gnproj.gn_proj_fwd` (inference only; off on the int8 path).
Under ToMe the attention and LayerNorm sites run at the merged length.
Each wrapper runs its plain version for a CPU tensor.

Under tp (`parallel/mesh.py::shard_tp_`) each attention site and
feed-forward holds its rank's heads and columns: the routes take the local
shapes (H/tp heads, C/tp or 4C/tp columns), and to_out_0 and net_2 are
row-parallel (`row_parallel_linear`: the product without bias, an
all-reduce over the tp group in the compute dtype (Megatron's g), then the
bias, as psd_tpu's bf16 dot, psum and bias; an int8 site `qdense`'s
row-parallel form, the whole K's scales and int32 sums). Megatron's f sits
at the replicated inputs of the column-parallel sites on the unfused paths
(the only ones training takes): the LayerNorm's output, so the LayerNorm's
weight and bias get their whole gradient, and the context tokens of the
cross-attention's K/V banks, so the conditioning modules do. A site that
was never cut runs as before, with no collective.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.mode import is_training, use_kernel
from ..parallel.mesh import copy_to_tp, reduce_from_tp, site_tp_group
from ..ops.attention import attention_probs, dot_product_attention
from ..ops.geglu import gelu_exact, ln_geglu_fwd, ln_proj_fwd, ln_reference, ln_shape_error
from ..ops.gnproj import gn_proj_fwd
from ..ops.kernels import device_scalar
from ..ops.norms import group_norm, group_norm_fold
from ..ops.quant import qconv3x3, qdense, quant_cols, quant_worthwhile
from ..ops.split3 import gated_sum, split3_attention, split3_shape_error
from ..ops.tome import ToMeSpec, build_merge, merge, unmerge
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


def row_parallel_linear(x, layer: nn.Linear, dtype, group):
    """`linear` of a row-parallel site cut over tp: each rank's product of
    its input columns without bias, summed over the tp group in dtype (g),
    then the whole bias in dtype; plain `linear` where `group` is None."""
    if group is None:
        return linear(x, layer, dtype)
    out = reduce_from_tp(F.linear(x.to(dtype), layer.weight.to(dtype)), group)
    return out + layer.bias.to(dtype)


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


def _int8_buffers_(module: nn.Module, sites) -> None:
    """Give `module` the non-persistent int8 weight buffers of its int8
    sites (`sites`: names of its Linear / Conv2d children): `<site>_wq`,
    int8 of the weight's shape with 1×1 kernels flattened to (N, K), and
    `<site>_sw`, the per-output-channel scales. `quantize_int8_weights_`
    sets them; checkpoints and the bridge never see them. Until it has,
    `int8_weights` quantizes the current fp32 weights at each use."""
    module.int8_sites = tuple(sites)
    module.int8_ready = False
    for name in module.int8_sites:
        w = getattr(module, name).weight
        shape = w.shape[:2] if w.ndim == 4 and w.shape[2:] == (1, 1) else w.shape
        module.register_buffer(f"{name}_wq", torch.zeros(shape, dtype=torch.int8, device=w.device),
                               persistent=False)
        module.register_buffer(f"{name}_sw", torch.zeros(shape[0], device=w.device),
                               persistent=False)


def int8_weights(module: nn.Module, name: str):
    """(int8 weights, per-output-channel scales) of the int8 site `name`:
    the buffers `quantize_int8_weights_` set (a serving model's, from the
    fp32 values before its weights were cast), or else the current fp32
    weights quantized at this use (a training model's masters), as psd_tpu
    quantizes its fp32 parameters at apply time."""
    wq = getattr(module, f"{name}_wq")
    if module.int8_ready:
        return wq, getattr(module, f"{name}_sw")
    if getattr(module, "tp", None) is not None:
        raise RuntimeError(f"{name}: a site cut over tp has no int8 weights set; they come "
                           "from the whole fp32 weights (quantize_int8_weights_ before the cut)")
    w = getattr(module, name).weight
    if w.dtype != torch.float32:
        raise ValueError(f"{name}: the int8 weights of {w.dtype} weights were never set; "
                         "call quantize_int8_weights_ before casting the weights")
    wq, sw = quant_cols(w.reshape(wq.shape), axis=0)
    return wq, sw.reshape(-1)


def int8_linear(x, module: nn.Module, name: str, dtype, group=None):
    """`qdense` of x with the site `name` of `module` (a Linear or a 1×1
    Conv2d): its int8 weights from K = 512 on, its own weight below; with
    `group`, row-parallel over the module's tp cut (the whole K's gate,
    scales and sums)."""
    layer = getattr(module, name)
    w = layer.weight
    w = w.reshape(w.shape[0], w.shape[1]) if w.ndim == 4 else w
    wq = sw = None
    if name in getattr(module, "int8_sites", ()):
        wq, sw = int8_weights(module, name)
    tp = module.tp.size if group is not None else 1
    return qdense(x, w, wq, sw, layer.bias, out_dtype=dtype, group=group, tp=tp)


class ResnetBlock2D(nn.Module):
    """GN→SiLU→conv → (+temb folded into GN) → GN→SiLU→conv → +shortcut.

    The up path's skip join is a real channel concat here; `psd_tpu` splits
    the conv weights to avoid materializing it, which is the same math.

    `quant="int8"` (inference only) runs conv1 and conv2 as W8A8 `qconv3x3`
    where psd_tpu's int8 gate admits the input
    (psd_tpu/models/layers.py:145-167, :233-247): `quant_gate="unet"`, the
    UNet's, at H, W ≤ 32; `quant_gate="vae"`, the SD decoder's win region,
    Cin ≥ 256 at ≤ 256², or Cin ≥ 128 with Cin == Cout. The int8 weights
    and their per-Cout scales are buffers, set from the fp32 weights by
    `quantize_int8_weights_`; on that branch norm2 runs without the temb
    fold and the embedding is added explicitly, as in psd_tpu."""

    def __init__(self, in_channels: int, out_channels: int, temb_dim: Optional[int] = None,
                 eps: float = 1e-5, groups: int = 32, dtype=torch.bfloat16,
                 quant: str = "none", quant_gate: str = "unet"):
        super().__init__()
        if quant not in ("none", "int8"):
            raise ValueError(f"quant must be 'none' or 'int8', got {quant!r}")
        if quant_gate not in ("unet", "vae"):
            raise ValueError(f"quant_gate must be 'unet' or 'vae', got {quant_gate!r}")
        self.dtype = dtype
        self.quant = quant
        self.quant_gate = quant_gate
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
            _int8_buffers_(self, ("conv1", "conv2"))

    def _q_conv_ok(self, x) -> bool:
        if self.quant != "int8" or is_training():
            return False
        if self.quant_gate == "unet":
            return x.shape[1] <= 32 and x.shape[2] <= 32
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
            h = qconv3x3(F.silu(gn(x, self.norm1)).to(dt), *int8_weights(self, "conv1"),
                         self.conv1.bias, out_dtype=dt)
            if emb is not None:
                h = h + emb[:, None, None, :].to(h.dtype)
            h = qconv3x3(F.silu(gn(h, self.norm2)).to(dt), *int8_weights(self, "conv2"),
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
    """Set the int8 weights and per-output-channel scales of every int8
    site under `module` (the int8 resblocks' 3×3 convs, the int8 UNet's
    Linear layers and 1×1 convs) from fp32 weights: the module's own (before
    `store_weights_in_` casts them), or `fp32_weights`, a state_dict of fp32
    tensors keyed as `module`'s (the bridge's, a checkpoint's). As psd_tpu
    quantizes the fp32 parameter tree (`ops/quant.py::quant_cols`, the
    output axis kept)."""
    for prefix, m in module.named_modules():
        if getattr(m, "int8_sites", ()) and getattr(m, "tp", None) is not None:
            raise RuntimeError(f"{prefix}: cut over tp; the int8 weights come from the whole "
                               "fp32 weights, before the cut")
        for name in getattr(m, "int8_sites", ()):
            key = f"{prefix}.{name}.weight" if prefix else f"{name}.weight"
            w = getattr(m, name).weight if fp32_weights is None else fp32_weights[key]
            if w.dtype != torch.float32:
                raise ValueError(f"{key}: int8 weights come from fp32 values, got {w.dtype}")
            wq_buf = getattr(m, f"{name}_wq")
            wq, sw = quant_cols(w.to(wq_buf.device).reshape(wq_buf.shape), axis=0)
            wq_buf.copy_(wq)
            getattr(m, f"{name}_sw").copy_(sw.reshape(-1))
        if getattr(m, "int8_sites", ()):
            m.int8_ready = True
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


def ln_fused_ok(x, n: Optional[int] = None) -> bool:
    """Shape gate of the fused LayerNorm kernels: every x (B, S, C) whose
    B·S rows and C channels they take with n output columns (ln_proj's C,
    ln_geglu's 4C per half; under tp a rank's C/tp and 4C/tp; C when not
    given) (`ln_shape_error`: B·S % 128, C % 64, n % 8). psd_tpu's gate
    (layers.py:591-613) asks B·S % 512 of its 512-row blocks, per shard
    under a mesh; here that would refuse a rank's 4 · 64 rows at 512²,
    which its one-process batch of 8 takes."""
    C = x.shape[-1]
    return ln_shape_error(x.shape[0] * x.shape[1], C, C if n is None else n) is None


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
    for cross-attention. `quant="int8"` (inference only, psd_tpu's
    `Attention(quant=)`): where the width is at least MIN_QUANT_K, those
    projections and to_out_0 run as `qdense` after a plain LayerNorm; the
    16-token cross-attention K/V stay in `dtype`. Cut over tp (`tp`, set by
    `parallel/mesh.py::cut_tp_`) it runs num_heads/tp heads and to_out_0
    row-parallel, the int8 gates reading the whole width."""

    tp_kind = "attention"

    def __init__(self, dim: int, num_heads: int, context_dim: Optional[int] = None,
                 mode: CrossAttnMode = CrossAttnMode(), dtype=torch.bfloat16,
                 quant: str = "none"):
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
        self.quant = quant
        self.tp = None
        self.proj_sites = ("to_q",) if self.is_cross else ("to_q", "to_k", "to_v")
        if quant == "int8" and quant_worthwhile(dim):
            _int8_buffers_(self, self.proj_sites + ("to_out_0",))

    def forward(self, x, context=None, delta_scale=None, ln_scale=None, ln_bias=None):
        dt = self.dtype
        B, S, C = x.shape
        hd = C // self.num_heads
        group = site_tp_group(self.tp)
        H = self.num_heads // (1 if self.tp is None else self.tp.size)  # this rank's heads
        use_q8 = self.quant == "int8" and quant_worthwhile(C) and not is_training()

        def heads(t):
            return t.reshape(B, -1, H, hd)

        ws = tuple(getattr(self, n).weight for n in self.proj_sites)
        if ln_scale is None and not use_q8:
            xt = copy_to_tp(x.to(dt), group)
            outs = [F.linear(xt, w.to(dt)) for w in ws]
        elif use_q8:
            hn = x.to(dt) if ln_scale is None else ln_reference(x.to(dt), ln_scale, ln_bias)
            outs = [int8_linear(hn, self, n, dt) for n in self.proj_sites]
        elif ln_fused_ok(x, H * hd) and use_kernel("ln_proj"):
            outs = ln_proj_fwd(x.reshape(B * S, C).to(dt), ln_scale, ln_bias,
                               tuple(w.to(dt) for w in ws))
            outs = [o.reshape(B, S, H * hd) for o in outs]
        else:
            hn = copy_to_tp(ln_reference(x.to(dt), ln_scale, ln_bias), group)
            outs = [F.linear(hn, w.to(dt)) for w in ws]
        q = heads(outs[0])
        if self.is_cross:
            context = copy_to_tp(context, group)

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
            # δ as split3 takes it (the UNet passes it so already); never
            # float(): it may be captured
            delta = device_scalar(delta_scale, q.device)
            lens = [b.shape[1] for b in banks[0::2]]
            if split3_kernel_ok(B, S, H, hd, lens) and use_kernel("split3"):
                z = split3_attention(q.contiguous(), *banks, delta, m.anat_gate, m.dis_gate)
            else:
                z = gated_sum(dot_product_attention(q, banks[0], banks[1]),
                              dot_product_attention(q, banks[2], banks[3]),
                              dot_product_attention(q, banks[4], banks[5]),
                              delta, m.anat_gate, m.dis_gate)
        elif self.mode.kind == "split2":
            z = split2_attention(q, heads(linear(context, self.to_k, dt)),
                                 heads(linear(context, self.to_v, dt)))
        else:
            ctx = context.to(dt)
            z = dot_product_attention(q, heads(linear(ctx, self.to_k, dt)),
                                      heads(linear(ctx, self.to_v, dt)))
        z = z.reshape(B, S, H * hd)
        if use_q8:
            return int8_linear(z, self, "to_out_0", dt, group)
        return row_parallel_linear(z, self.to_out_0, dt, group)


def split2_attention(q, k, v):
    """The split2 site's attention (psd_tpu/models/layers.py:475-490 at its
    scales of 1): fp32 probabilities, then P·V with P cast to v's dtype."""
    return torch.einsum("bhqk,bkhd->bqhd", attention_probs(q, k).to(v.dtype), v)


class GEGLUFeedForward(nn.Module):
    """LN (passed in) → GEGLU projection dim→8·dim, split, h·gelu(g) →
    net_2 (4·dim→dim). `quant="int8"` (inference only, psd_tpu's
    `GEGLUFeedForward(quant=)`): each projection runs as `qdense` where its
    depth is at least MIN_QUANT_K (net_0 at dim, net_2 at 4·dim), so at
    dim = 320 net_0 keeps the fused LN → GEGLU kernel and net_2 is int8.
    Cut over tp (`tp`) it holds N/tp of each GEGLU half's N = 4·dim columns,
    packed [h_r ; g_r], and net_2 runs row-parallel; the int8 gates read
    the whole N."""

    tp_kind = "geglu"

    def __init__(self, dim: int, mult: int = 4, dtype=torch.bfloat16, quant: str = "none"):
        super().__init__()
        self.dtype = dtype
        self.quant = quant
        self.tp = None
        self.net_0_proj = nn.Linear(dim, dim * mult * 2)
        self.net_2 = nn.Linear(dim * mult, dim)
        if quant == "int8":
            _int8_buffers_(self, [n for n, k in (("net_0_proj", dim), ("net_2", dim * mult))
                                  if quant_worthwhile(k)])

    def forward(self, x, ln_scale, ln_bias):
        dt = self.dtype
        B, S, C = x.shape
        use_q8 = self.quant == "int8" and not is_training()
        group = site_tp_group(self.tp)
        w0, b0 = self.net_0_proj.weight, self.net_0_proj.bias
        if use_q8 and quant_worthwhile(C):
            proj = int8_linear(ln_reference(x.to(dt), ln_scale, ln_bias), self, "net_0_proj",
                               torch.float32)
            hh, g = proj.chunk(2, dim=-1)
            h = (hh * gelu_exact(g)).to(dt)
        elif ln_fused_ok(x, w0.shape[0] // 2) and use_kernel("ln_geglu"):
            h = ln_geglu_fwd(x.reshape(B * S, C).to(dt), ln_scale, ln_bias,
                             w0.to(dt), b0).reshape(B, S, -1)
        else:
            hn = copy_to_tp(ln_reference(x.to(dt), ln_scale, ln_bias), group)
            proj = F.linear(hn, w0.to(dt))
            hh, g = (proj.float() + b0.float()).chunk(2, dim=-1)
            h = (hh * gelu_exact(g)).to(dt)
        if use_q8 and quant_worthwhile(h.shape[-1] * (1 if self.tp is None else self.tp.size)):
            return int8_linear(h, self, "net_2", dt, group)
        return row_parallel_linear(h, self.net_2, dt, group)


class BasicTransformerBlock(nn.Module):
    """x + attn1(LN1 x) → x + attn2(LN2 x, ctx) → x + FF(LN3 x).

    `tome` (a `ToMeSpec`, inference only, psd_tpu's
    `BasicTransformerBlock(tome=, hw=)`): at sites of at least
    `tome.min_tokens` tokens one merge is built from the block input on its
    (H, W) grid `hw`. "branch" mode runs attn1 on the merged tokens (and
    attn2's query with `merge_cross`, the FF with `merge_mlp`) and unmerges
    each branch's output; "block" mode merges once at entry, runs the whole
    block at the merged length and unmerges once at exit."""

    def __init__(self, dim: int, num_heads: int, context_dim: int,
                 mode: CrossAttnMode = CrossAttnMode(), dtype=torch.bfloat16,
                 quant: str = "none", tome: Optional[ToMeSpec] = None):
        super().__init__()
        self.tome = tome
        self.norm1 = nn.LayerNorm(dim)
        self.attn1 = Attention(dim, num_heads, dtype=dtype, quant=quant)
        self.norm2 = nn.LayerNorm(dim)
        self.attn2 = Attention(dim, num_heads, context_dim, mode, dtype=dtype, quant=quant)
        self.norm3 = nn.LayerNorm(dim)
        self.ff = GEGLUFeedForward(dim, dtype=dtype, quant=quant)

    def forward(self, x, context, delta_scale=None, hw=None):
        S = x.shape[1]
        t = self.tome
        mi = None
        if t is not None and hw is not None and t.active(S) and not is_training():
            mi = build_merge(x, hw[0], hw[1], t.r_count(S))
        block = mi is not None and t.mode == "block"
        if block:
            x = merge(x, mi)

        def branch(fn, h, merged: bool):
            if mi is None or block or not merged:
                return fn(h)
            return unmerge(fn(merge(h, mi)), mi)

        x = x + branch(lambda h: self.attn1(h, ln_scale=self.norm1.weight,
                                            ln_bias=self.norm1.bias), x, True)
        x = x + branch(lambda h: self.attn2(h, context, delta_scale, ln_scale=self.norm2.weight,
                                            ln_bias=self.norm2.bias), x,
                       mi is not None and t.merge_cross)
        x = x + branch(lambda h: self.ff(h, self.norm3.weight, self.norm3.bias), x,
                       mi is not None and t.merge_mlp)
        # block mode: merged tokens take their region dst's output
        return unmerge(x, mi) if block else x


class Transformer2D(nn.Module):
    """GN → proj_in (1×1) → transformer block(s) → proj_out (1×1) → +x.

    `quant="int8"`: gn_proj off, proj_in / proj_out by `qdense` (int8 from
    C = 512 on), as psd_tpu's `Transformer2D(quant=)`; `tome` goes to the
    blocks with the site's (H, W)."""

    def __init__(self, channels: int, num_heads: int, context_dim: int, depth: int = 1,
                 mode: CrossAttnMode = CrossAttnMode(), dtype=torch.bfloat16,
                 quant: str = "none", tome: Optional[ToMeSpec] = None):
        super().__init__()
        self.dtype = dtype
        self.depth = depth
        self.quant = quant
        self.norm = nn.GroupNorm(32, channels, eps=1e-6)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        for d in range(depth):
            self.add_module(f"transformer_blocks_{d}", BasicTransformerBlock(
                channels, num_heads, context_dim, mode, dtype=dtype, quant=quant, tome=tome))
        self.proj_out = nn.Conv2d(channels, channels, 1)
        if quant == "int8" and quant_worthwhile(channels):
            _int8_buffers_(self, ("proj_in", "proj_out"))

    def forward(self, x, context, delta_scale=None):
        B, H, W, C = x.shape
        S = H * W
        use_q8 = self.quant == "int8" and not is_training()
        if use_q8:
            h = int8_linear(gn(x, self.norm), self, "proj_in", self.dtype).reshape(B, S, C)
        elif gn_proj_ok(S, C) and use_kernel("gn_proj"):
            # folded GroupNorm affine + proj_in as one kernel (layers.py:835-857)
            n = self.norm
            w, b = group_norm_fold(x, n.weight, n.bias, n.num_groups, n.eps)
            h = gn_proj_fwd(x.reshape(B, S, C).to(self.dtype), w, b,
                            self.proj_in.weight.reshape(C, C).to(self.dtype),
                            self.proj_in.bias)
        else:
            h = conv1x1(gn(x, self.norm), self.proj_in, self.dtype).reshape(B, S, C)
        for d in range(self.depth):
            h = getattr(self, f"transformer_blocks_{d}")(h, context, delta_scale, hw=(H, W))
        h = h.reshape(B, H, W, C)
        if use_q8:
            h = int8_linear(h, self, "proj_out", self.dtype)
        else:
            h = conv1x1(h, self.proj_out, self.dtype)
        return h + x
