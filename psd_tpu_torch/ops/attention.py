"""Softmax attention: the shape routing, the kernel wrapper and its plain
version.

Counterpart of `psd_tpu/ops/attention.py` + `ops/spattn.py` + `ops/flash.py`.
The TPU package routes long non-causal attention to two Pallas programs:
`spattn` (S%256==0, S≤4096, D≤256: the UNet self-attention) and JAX's stock
flash kernel (S%128==0: the VAE mid-block, single head, D=512). Both compute
the same function, so here ONE kernel, `csrc/attention.cu`, serves both roles.
Everything shorter takes the plain einsum path, as in JAX.

`attention_fwd` is the kernel wrapper: a CPU tensor goes to
`attention_reference`; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.mode import use_kernel
from . import kernels


def attention_reference(q, k, v, scale: Optional[float] = None):
    """Plain attention, (B, Sq, H, D) → (B, Sq, H, D) in q.dtype: fp32 logits
    and softmax, probabilities cast to v.dtype (psd_tpu/ops/attention.py:61-67)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    probs = torch.softmax(logits * scale, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).to(q.dtype)


def kernel_route(q, k) -> Optional[str]:
    """Which TPU kernel's role a shape takes (attention.py:46-67), else None."""
    Sq, D = q.shape[1], q.shape[-1]
    Sk = k.shape[1]
    if Sq == Sk and Sq >= 512 and Sq % 256 == 0 and Sq <= 4096 and D <= 256:
        return "spattn"
    if Sq >= 512 and Sk >= 512 and Sq % 128 == 0 and Sk % 128 == 0:
        return "flash"
    return None


def attention_fwd(q, k, v, scale: Optional[float] = None):
    """Non-causal softmax attention; kernel on CUDA, plain version on CPU."""
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    if not q.is_cuda:
        return attention_reference(q, k, v, scale)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    kernels.require_cuda_bf16("attention_fwd", q, k, v)
    kernels.require(k.shape == (B, Sk, H, D) and v.shape == k.shape,
                    f"attention_fwd: k/v shape {tuple(k.shape)}/{tuple(v.shape)}")
    kernels.require(D % 8 == 0 and D <= 512, f"attention_fwd: head dim {D}")
    kernels.require(Sq % 64 == 0 and Sk % 64 == 0,
                    f"attention_fwd: sequence lengths {Sq}, {Sk} must be multiples of 64")
    out = torch.empty_like(q)
    lib = kernels.library()
    code = lib.psd_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 out.data_ptr(), B, Sq, Sk, H, D, scale,
                                 kernels.stream_ptr(q))
    kernels.check(code, "attention_fwd")
    kernels.launch_counts["attention"] += 1
    kernels.attention_head_dims[D] += 1
    return out


def dot_product_attention(q, k, v, scale: Optional[float] = None):
    """Multi-head attention, (B, S, H, D) layout, output in q.dtype."""
    if kernel_route(q, k) is not None and use_kernel("attention"):
        return attention_fwd(q.contiguous(), k.contiguous(), v.contiguous(), scale)
    return attention_reference(q, k, v, scale)
