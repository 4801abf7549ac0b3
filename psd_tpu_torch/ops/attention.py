"""Softmax attention: the shape routing, the kernel wrappers, their plain
versions and the autograd.Function that trains through them.

Counterpart of `psd_tpu/ops/attention.py` + `ops/spattn.py` + `ops/flash.py`.
The TPU package routes long non-causal attention to two Pallas programs:
`spattn` (S%256==0, S≤4096, D≤256: the UNet self-attention, inference only)
and JAX's stock flash kernel (S%128==0, S≥512; in training it is the only
kernel, with its fused dq/dkv backward kernels). Both compute the same
function, so here ONE forward entry point, `csrc/attention.cu`, serves both
roles with two TMA/wgmma kernels: `csrc/attention_narrow.cu` for head dims
up to 160 (the UNet, D = 40/80) and `csrc/attention_wide.cu` for wider
heads (the VAE mid block, D = 512); `fwd_shape_error` says which shapes
they take. `csrc/attention_bwd.cu` is the flash backward (head dims up to
160, `bwd_shape_error`). Everything shorter takes the plain einsum path, as
in JAX, and so does a shape psd_tpu routes but the kernels refuse
(`kernel_route` consults both).

`attention_fwd` and `attention_bwd` are the kernel wrappers: a CPU tensor
goes to the plain version; a CUDA tensor launches the kernel or raises.
`FlashAttention` is the autograd.Function: its forward is the forward
kernel asked for the per-row log-sum-exp, its backward the backward kernel.

`spatial_attention` is psd_tpu's op of the same name, the one path to its
int8 kernel `_kernel_q8` (`quant="qk8" | "int8"`; no model path passes
`quant=`, in psd_tpu as here): a plain-torch quantization pre-pass
(`quantize_qkv`), then `attention_q8`, the wrapper of `csrc/attention_q8.cu`
(plain version `attention_q8_reference`, exact integer products), which
takes the shapes `q8_shape_error` admits.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.mode import is_training, use_kernel
from . import kernels

LOG2E = 1.4426950408889634


def attention_reference(q, k, v, scale: Optional[float] = None):
    """Plain attention, (B, Sq, H, D) → (B, Sq, H, D) in q.dtype: fp32 logits
    and softmax, probabilities cast to v.dtype (psd_tpu/ops/attention.py:61-67)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    probs = torch.softmax(logits * scale, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).to(q.dtype)


def attention_probs(q, k, scale: Optional[float] = None):
    """softmax(q·kᵀ·scale), (B, H, Sq, Sk) fp32: the split2 cross-attention
    site's probabilities (psd_tpu/ops/attention.py:70-76)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    return torch.softmax(logits * scale, dim=-1)


def lse_reference(q, k, scale: float):
    """Per-row log-sum-exp of the scaled logits in log2 units, (B, H, Sq) fp32
    (the forward kernel's second output)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    return torch.logsumexp(logits, dim=-1) * LOG2E


def attention_bwd_reference(q, k, v, dout, scale: Optional[float] = None):
    """(dq, dk, dv): autograd through `attention_reference`."""
    with torch.enable_grad():
        qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = attention_reference(*qkv, scale)
        return torch.autograd.grad(out, qkv, dout)


def psd_tpu_route(Sq: int, Sk: int, D: int, training: bool = False) -> Optional[str]:
    """The TPU kernel whose role a (·, Sq, ·, D) attention against
    (·, Sk, ·, D) keys takes in psd_tpu (attention.py:46-67), else None.
    In training only the stock flash kernel runs (its backward is fused)."""
    if (not training and Sq == Sk and Sq >= 512 and Sq % 256 == 0 and Sq <= 4096
            and D <= 256):
        return "spattn"
    if Sq >= 512 and Sk >= 512 and Sq % 128 == 0 and Sk % 128 == 0:
        return "flash"
    return None


def kernel_route(q, k, training: bool = False) -> Optional[str]:
    """psd_tpu's route (`psd_tpu_route`) where the port's kernels admit the
    shape (`fwd_shape_error`, and in training `bwd_shape_error` too), else
    None: a shape they refuse takes the plain path, as psd_tpu's None
    return does."""
    Sq, D = q.shape[1], q.shape[-1]
    Sk = k.shape[1]
    role = psd_tpu_route(Sq, Sk, D, training)
    if role is None or fwd_shape_error(Sq, Sk, D) is not None:
        return None
    if training and bwd_shape_error(Sq, Sk, D) is not None:
        return None
    return role


# the forward kernels' tiles (csrc/attention_narrow.cu, attention_wide.cu):
# head dims up to NARROW_MAX_D take the narrow kernel, whose blocks hold 128
# query rows and whose key tiles are 64 or 128 keys; wider heads, up to
# WIDE_MAX_D, take the wide kernel (64 query rows, 32-key tiles)
NARROW_MAX_D, NARROW_S_MULTIPLE = 160, 128
WIDE_MAX_D, WIDE_S_MULTIPLE = 512, 64


def fwd_shape_error(Sq: int, Sk: int, D: int) -> Optional[str]:
    """None when the forward kernels take q (·, Sq, ·, D) against k/v
    (·, Sk, ·, D), else why not. Any batch and head count."""
    if D % 8 or not 0 < D <= WIDE_MAX_D:
        return f"head dim {D} must be a multiple of 8 up to {WIDE_MAX_D}"
    mult = NARROW_S_MULTIPLE if D <= NARROW_MAX_D else WIDE_S_MULTIPLE
    if Sq % mult or Sk % mult or not (Sq and Sk):
        return f"sequence lengths {Sq}, {Sk} must be multiples of {mult} at head dim {D}"
    return None


# the backward kernels' tiles (csrc/attention_bwd.cu): head dims up to
# NARROW_MAX_D; the dQ pass's work items are 128 query rows, the dK/dV
# pass's 128 key rows
BWD_S_MULTIPLE = 128


def bwd_shape_error(Sq: int, Sk: int, D: int) -> Optional[str]:
    """None when the backward kernels take q (·, Sq, ·, D) against k/v
    (·, Sk, ·, D), else why not. Any batch and head count."""
    if D % 8 or not 0 < D <= NARROW_MAX_D:
        return f"head dim {D} must be a multiple of 8 up to {NARROW_MAX_D}"
    if Sq % BWD_S_MULTIPLE or Sk % BWD_S_MULTIPLE or not (Sq and Sk):
        return f"sequence lengths {Sq}, {Sk} must be multiples of {BWD_S_MULTIPLE}"
    return None


def attention_fwd(q, k, v, scale: Optional[float] = None, return_lse: bool = False):
    """Non-causal softmax attention; kernel on CUDA, plain version on CPU.
    With `return_lse`, also the per-row log-sum-exp (log2 units, (B, H, Sq))."""
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    if not q.is_cuda:
        out = attention_reference(q, k, v, scale)
        return (out, lse_reference(q, k, scale)) if return_lse else out
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    kernels.require_no_grad("attention_fwd", q, k, v)
    kernels.require_cuda_bf16("attention_fwd", q, k, v)
    kernels.require(k.shape == (B, Sk, H, D) and v.shape == k.shape,
                    f"attention_fwd: k/v shape {tuple(k.shape)}/{tuple(v.shape)}")
    err = fwd_shape_error(Sq, Sk, D)
    kernels.require(err is None, f"attention_fwd: {err}")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) if return_lse else None
    lib = kernels.library()
    code = lib.psd_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                 0 if lse is None else lse.data_ptr(), B, Sq, Sk, H, D,
                                 scale, kernels.stream_ptr(q))
    kernels.check(code, "attention_fwd")
    kernels.launch_counts["attention"] += 1
    kernels.attention_head_dims[D] += 1
    return (out, lse) if return_lse else out


def attention_bwd(q, k, v, out, lse, dout, scale: Optional[float] = None):
    """(dq, dk, dv) of attention at (q, k, v) for the output gradient dout,
    given the forward's output and log-sum-exp; kernel on CUDA, autograd
    through the plain version on CPU."""
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    if not q.is_cuda:
        return attention_bwd_reference(q, k, v, dout, scale)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    kernels.require_cuda_bf16("attention_bwd", q, k, v, out, dout)
    kernels.require(k.shape == (B, Sk, H, D) and v.shape == k.shape
                    and out.shape == q.shape and dout.shape == q.shape,
                    "attention_bwd: operand shapes")
    err = bwd_shape_error(Sq, Sk, D)
    kernels.require(err is None, f"attention_bwd: {err}")
    kernels.require_cuda_f32("attention_bwd", q.device, lse)
    kernels.require(lse.shape == (B, H, Sq) and lse.data_ptr() % 16 == 0,
                    "attention_bwd: lse must be 16-byte aligned (B, H, Sq)")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    code = kernels.library().psd_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, Sq, Sk, H, D, scale, kernels.stream_ptr(q))
    kernels.check(code, "attention_bwd")
    kernels.launch_counts["attention_bwd"] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention whose forward and backward are the kernels (flash role)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = attention_fwd(q, k, v, scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, out, lse, dout.contiguous(), ctx.scale)
        return dq, dk, dv, None


def dot_product_attention(q, k, v, scale: Optional[float] = None):
    """Multi-head attention, (B, S, H, D) layout, output in q.dtype."""
    if kernel_route(q, k, is_training()) is not None and use_kernel("attention"):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            return FlashAttention.apply(q, k, v, scale)
        return attention_fwd(q, k, v, scale)
    return attention_reference(q, k, v, scale)


# ---- int8 spatial attention (psd_tpu/ops/spattn.py::_kernel_q8) -------------

def _padded_dim(D: int) -> int:
    """Head dim padded to the int8 MMA depth (32 bytes): 40→64, 80→96."""
    return (D + 31) // 32 * 32


# what csrc/attention_q8.cu takes: every shape spatial_attention routes
# (S % 256 == 0, S <= 4096, D <= 256) whose head dim is a multiple of 8 (TMA's
# 16-byte strides for the bf16 v of "qk8"); its blocks hold 128 query rows and
# its key tiles 128 keys
Q8_MAX_D, Q8_S_MULTIPLE, Q8_MAX_S = 256, 256, 4096


def q8_shape_error(S: int, D: int) -> Optional[str]:
    """None when the int8 attention kernel takes a (·, S, ·, D) attention,
    else why not. Any batch and head count."""
    if D % 8 or not 0 < D <= Q8_MAX_D:
        return f"head dim {D} must be a multiple of 8 up to {Q8_MAX_D}"
    if S % Q8_S_MULTIPLE or not 0 < S <= Q8_MAX_S:
        return f"sequence length {S} must be a multiple of {Q8_S_MULTIPLE} up to {Q8_MAX_S}"
    return None


# The int8 P·V product takes pq straight from the QKᵀ accumulator as its A
# operand, whose register holds 4 consecutive k where the accumulator holds
# pairs of keys (csrc/attention_q8.cu). So vq's keys are placed within each
# 32-key chunk: position 16·hi + 4·t + 2·e1 + e0 holds key
# 16·hi + 8·e1 + 2·t + e0 (hi, e1, e0 in {0, 1}, t in 0..3), a swap of the
# t and e1 axes. The contraction over keys does not depend on their order.
Q8_KEY_CHUNK = 32


def q8_key_position(key):
    """Where key `key` (an int or an integer tensor) sits in the last axis
    of vq as quantize_qkv writes it."""
    k = key % Q8_KEY_CHUNK
    hi, e1, t, e0 = k // 16, (k // 8) % 2, (k // 2) % 4, k % 2
    return key - k + 16 * hi + 4 * t + 2 * e1 + e0


def _swap_in_chunks(x, shape):
    lead, S = x.shape[:-1], x.shape[-1]
    return x.reshape(*lead, S // Q8_KEY_CHUNK, *shape).transpose(-3, -2).reshape(*lead, S)


def q8_place_keys(x):
    """(..., S) with keys in order → the kernel's placement (q8_key_position)."""
    return _swap_in_chunks(x, (2, 2, 4, 2))


def q8_unplace_keys(x):
    """The inverse of q8_place_keys: keys back in order."""
    return _swap_in_chunks(x, (2, 4, 2, 2))


def quantize_qkv(q, k, v, pv8: bool):
    """The quantization pre-pass of `psd_tpu/ops/spattn.py:116-127`, plain
    torch as in psd_tpu (XLA outside the kernel), into the layouts
    `attention_q8` takes. q, k, v: (B, S, H, D). Returns
      qq, kq: (B·H, S, Dp) int8, D zero-padded to Dp = ceil32(D);
      sq, sk: (B·H, S) fp32 row scales;
      v:  "qk8": v itself (B, S, H, D); "int8": vq (B·H, Dp, S) int8, key-major
          (the B operand of the int8 P·V), zero-padded rows D..Dp, keys
          placed within 32-key chunks by q8_place_keys;
      sv: "int8": (B·H, Dp) fp32 column scales over S (1 in the padding);
          "qk8": None."""
    from .quant import quant_rows

    B, S, H, D = q.shape
    Dp = _padded_dim(D)

    def rows(t):
        tq, ts = quant_rows(t)  # (B, S, H, D), (B, S, H, 1)
        tq = F.pad(tq.permute(0, 2, 1, 3), (0, Dp - D)).reshape(B * H, S, Dp)
        return tq.contiguous(), ts[..., 0].permute(0, 2, 1).reshape(B * H, S).contiguous()

    qq, sq = rows(q)
    kq, sk = rows(k)
    if not pv8:
        return qq, sq, kq, sk, v, None
    vf = v.float()
    sv = vf.abs().amax(dim=1, keepdim=True).clamp_min(1e-8) * (1.0 / 127.0)  # (B,1,H,D)
    vq = torch.round(vf / sv).to(torch.int8)
    vq = q8_place_keys(F.pad(vq.permute(0, 2, 3, 1), (0, 0, 0, Dp - D)).reshape(B * H, Dp, S))
    vq = vq.contiguous()
    sv = F.pad(sv[:, 0], (0, Dp - D), value=1.0).reshape(B * H, Dp).contiguous()
    return qq, sq, kq, sk, vq, sv


def _exact_matmul(a, b):
    """Product of integer-valued tensors, exact: fp64 holds every partial
    sum here (|Σ| ≤ 127²·4096 < 2⁵³), on the CPU and on the card alike."""
    return torch.matmul(a.double(), b.double())


# batch·heads the plain int8 attention takes at a time: bounds its (chunk, S, S)
# fp32 logits (512 MiB at S = 4096)
Q8_REFERENCE_CHUNK = 8


def attention_q8_reference(qq, sq, kq, sk, v, sv, scale: float, shape, out_dtype=None):
    """Plain version of the int8 kernel, line for line after
    `psd_tpu/ops/spattn.py:75-105`, on the layouts of `quantize_qkv`
    ("int8" mode when `sv` is given, else "qk8"); `shape` = (B, S, H, D) of
    the attention. Returns (B, S, H, D) in `out_dtype` (default: v's dtype
    in "qk8", fp32 in "int8"). The integer products are exact."""
    B, S, H, D = shape
    pv8 = sv is not None
    out_dtype = out_dtype or (torch.float32 if pv8 else v.dtype)
    vt = vq_t = None
    if pv8:
        vq_t = q8_unplace_keys(v[:, :D, :]).transpose(1, 2)  # (BH, S, D) int8
    else:
        vt = v.permute(0, 2, 1, 3).reshape(B * H, S, D)
    c = float(np.float32(scale * LOG2E))
    outs = []
    for i in range(0, B * H, Q8_REFERENCE_CHUNK):
        sl = slice(i, i + Q8_REFERENCE_CHUNK)
        acc = _exact_matmul(qq[sl, :, :D], kq[sl, :, :D].transpose(1, 2)).float()
        # log2e folds into the row dequant scale → raw exp2 exponentials
        logits = acc * (sq[sl, :, None] * c) * sk[sl, None, :]
        m = logits.amax(dim=-1, keepdim=True)
        p = torch.exp2(logits - m)
        l = p.sum(dim=-1, keepdim=True)
        if pv8:
            # probabilities normalized, then quantized per row
            pn = p / l
            ps = pn.amax(dim=-1, keepdim=True).clamp_min(1e-20) * (1.0 / 127.0)
            pq = torch.round(pn / ps)
            z = _exact_matmul(pq, vq_t[sl]).float() * ps * sv[sl, None, :D]
        else:
            z = torch.matmul(p.to(vt.dtype).float(), vt[sl].float()) / l
        outs.append(z.to(out_dtype))
    return torch.cat(outs).reshape(B, H, S, D).permute(0, 2, 1, 3)


def attention_q8(qq, sq, kq, sk, v, sv, scale: float, shape, out_dtype=None):
    """The int8 spatial attention (`_kernel_q8`) on pre-quantized operands
    (the layouts of `quantize_qkv`; "int8" mode when `sv` is given, else
    "qk8"); `shape` = (B, S, H, D). Kernel on CUDA (bf16 out), plain version
    on CPU. Returns (B, S, H, D)."""
    if not qq.is_cuda:
        return attention_q8_reference(qq, sq, kq, sk, v, sv, scale, shape, out_dtype)
    kernels.require_no_grad("attention_q8", qq, sq, kq, sk, v, *(() if sv is None else (sv,)))
    B, S, H, D = shape
    Dp = _padded_dim(D)
    BH, pv8 = B * H, sv is not None
    out_dtype = out_dtype or torch.bfloat16
    dev = qq.device
    kernels.require(out_dtype == torch.bfloat16, f"attention_q8: bf16 output, got {out_dtype}")
    err = q8_shape_error(S, D)
    kernels.require(err is None, f"attention_q8: {err}")
    for name, t, shp in (("qq", qq, (BH, S, Dp)), ("kq", kq, (BH, S, Dp))):
        kernels.require(t.device == dev and t.dtype == torch.int8 and t.is_contiguous()
                        and tuple(t.shape) == shp and t.data_ptr() % 16 == 0,
                        f"attention_q8: {name} must be contiguous int8 {shp}")
    kernels.require_cuda_f32("attention_q8", dev, sq, sk)
    kernels.require(all(t.data_ptr() % 16 == 0 for t in (sq, sk) + ((sv,) if pv8 else ())),
                    "attention_q8: 16-byte aligned scales")
    kernels.require(tuple(sq.shape) == (BH, S) and tuple(sk.shape) == (BH, S),
                    "attention_q8: sq, sk must be (B·H, S)")
    if pv8:
        kernels.require(v.device == dev and v.dtype == torch.int8 and v.is_contiguous()
                        and tuple(v.shape) == (BH, Dp, S) and v.data_ptr() % 16 == 0,
                        f"attention_q8: vq must be contiguous int8 {(BH, Dp, S)}")
        kernels.require_cuda_f32("attention_q8", dev, sv)
        kernels.require(tuple(sv.shape) == (BH, Dp), "attention_q8: sv must be (B·H, Dp)")
    else:
        kernels.require_cuda_bf16("attention_q8", v)
        kernels.require(tuple(v.shape) == (B, S, H, D), "attention_q8: v must be (B, S, H, D)")
    out = torch.empty((B, S, H, D), dtype=out_dtype, device=dev)
    code = kernels.library().psd_attention_q8_fwd(
        qq.data_ptr(), sq.data_ptr(), kq.data_ptr(), sk.data_ptr(), v.data_ptr(),
        0 if sv is None else sv.data_ptr(), out.data_ptr(), B, S, H, D,
        float(np.float32(scale * LOG2E)), int(pv8), kernels.stream_ptr(qq))
    kernels.check(code, "attention_q8")
    kernels.launch_counts["attention_q8"] += 1
    return out


def spatial_attention_routes(Sq: int, Sk: int, D: int) -> bool:
    """Whether psd_tpu's spatial_attention takes a (·, Sq, ·, D) attention
    against (·, Sk, ·, D) keys (`psd_tpu/ops/spattn.py:221-268`)."""
    return Sq == Sk and Sq % 256 == 0 and Sq <= 4096 and D <= 256


def spatial_attention(q, k, v, scale: Optional[float] = None, block_q: Optional[int] = None,
                      quant: str = "none"):
    """psd_tpu's `spatial_attention` op (`psd_tpu/ops/spattn.py:221-268`),
    (B, S, H, D) in and out: None when the caller should take another path
    (Sq != Sk, S % 256, S > 4096 or D > 256). quant "none" runs the
    attention kernel (spattn role); "qk8" (int8 QKᵀ) and "int8" (int8 QKᵀ
    and P·V) quantize q, k (and v) in plain torch, then run the int8
    kernel; inference only. `block_q` (psd_tpu's query tile) must be None:
    the kernels fix their own query tile."""
    if block_q is not None:
        raise ValueError("spatial_attention: block_q must be None; the CUDA kernels fix "
                         "their own query tile")
    B, Sq, H, D = q.shape
    if not spatial_attention_routes(Sq, k.shape[1], D):
        return None
    sm_scale = float(scale) if scale is not None else D ** -0.5
    if quant in ("qk8", "int8"):
        ops = quantize_qkv(q, k, v, quant == "int8")
        return attention_q8(*ops, sm_scale, q.shape, q.dtype)
    if quant != "none":
        raise ValueError(f"quant must be 'none', 'qk8' or 'int8', got {quant!r}")
    return attention_fwd(q.contiguous(), k.contiguous(), v.contiguous(), sm_scale)
