"""Softmax attention: the shape routing, the kernel wrappers, their plain
versions and the autograd.Function that trains through them.

Counterpart of `psd_tpu/ops/attention.py` + `ops/spattn.py` + `ops/flash.py`.
The TPU package routes long non-causal attention to two Pallas programs:
`spattn` (S%256==0, S≤4096, D≤256: the UNet self-attention, inference only)
and JAX's stock flash kernel (S%128==0, S≥512; in training it is the only
kernel, with its fused dq/dkv backward kernels). Both compute the same
function, so here ONE forward kernel, `csrc/attention.cu`, serves both roles,
and `csrc/attention_bwd.cu` is the flash backward. Everything shorter takes
the plain einsum path, as in JAX.

`attention_fwd` and `attention_bwd` are the kernel wrappers: a CPU tensor
goes to the plain version; a CUDA tensor launches the kernel or raises.
`FlashAttention` is the autograd.Function: its forward is the forward
kernel asked for the per-row log-sum-exp, its backward the backward kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.mode import is_training, use_kernel
from . import kernels

LOG2E = 1.4426950408889634
# padded head dims the backward kernel is instantiated for (attention_bwd.cu)
BWD_PADDED_DIMS = (32, 48, 64, 80, 96, 128, 160)


def attention_reference(q, k, v, scale: Optional[float] = None):
    """Plain attention, (B, Sq, H, D) → (B, Sq, H, D) in q.dtype: fp32 logits
    and softmax, probabilities cast to v.dtype (psd_tpu/ops/attention.py:61-67)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    probs = torch.softmax(logits * scale, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).to(q.dtype)


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


def kernel_route(q, k, training: bool = False) -> Optional[str]:
    """Which TPU kernel's role a shape takes (attention.py:46-67), else None.
    In training only the stock flash kernel runs (its backward is fused)."""
    Sq, D = q.shape[1], q.shape[-1]
    Sk = k.shape[1]
    if (not training and Sq == Sk and Sq >= 512 and Sq % 256 == 0 and Sq <= 4096
            and D <= 256):
        return "spattn"
    if Sq >= 512 and Sk >= 512 and Sq % 128 == 0 and Sk % 128 == 0:
        return "flash"
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
    kernels.require_cuda_bf16("attention_fwd", q, k, v)
    kernels.require(k.shape == (B, Sk, H, D) and v.shape == k.shape,
                    f"attention_fwd: k/v shape {tuple(k.shape)}/{tuple(v.shape)}")
    kernels.require(D % 8 == 0 and D <= 512, f"attention_fwd: head dim {D}")
    kernels.require(Sq % 64 == 0 and Sk % 64 == 0,
                    f"attention_fwd: sequence lengths {Sq}, {Sk} must be multiples of 64")
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
    kernels.require(D % 8 == 0 and (D + 15) // 16 * 16 in BWD_PADDED_DIMS,
                    f"attention_bwd: head dim {D}")
    kernels.require(Sq % 64 == 0 and Sk % 64 == 0,
                    f"attention_bwd: sequence lengths {Sq}, {Sk} must be multiples of 64")
    kernels.require_cuda_f32("attention_bwd", q.device, lse)
    kernels.require(lse.shape == (B, H, Sq), "attention_bwd: lse must be (B, H, Sq)")
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
