"""Folded GroupNorm affine fused into the projection that follows it
(Transformer2D's GroupNorm → proj_in): kernel wrapper and plain version.

Counterpart of `psd_tpu/ops/gnproj.py`. The GroupNorm statistics reduce to a
per-(batch, channel) affine (w, b) (`ops/norms.py::group_norm_fold`, plain
torch); given it,

    out = bf16(x·w + b in fp32) · Wᵀ, fp32 accumulation, + bias (fp32) → x.dtype

W is in PyTorch's Linear layout (N, C). The kernel is `csrc/gn_proj.cu`,
Kind::kGn of the wgmma template `csrc/ln_gemm_sm90.cuh` (one launch, no
statistics pass).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import kernels


def gn_proj_reference(x, w, b, weight, bias):
    """(B, S, C) x, (B, C) fp32 affine, (N, C) weight, (N,) bias → (B, S, N)
    (psd_tpu/ops/gnproj.py::_xla_reference, one output)."""
    xa = (x.float() * w.float()[:, None, :] + b.float()[:, None, :]).to(x.dtype)
    out = F.linear(xa, weight.to(x.dtype)).float() + bias.float()
    return out.to(x.dtype)


def gn_shape_error(B: int, S: int, C: int, N: int) -> Optional[str]:
    """Why the kernel does not take x (B, S, C) with N output columns, or
    None when it does: 128-row tiles that cover at most two batch elements
    (S % 64 == 0, so S ≥ 64; where B·S % 128 == 64 the last tile is half
    full), 64-column K chunks (one TMA box) and 16-byte output rows. Every
    shape `Transformer2D` routes (S % 64 == 0, C % 64 == 0, N = C, any B)
    passes."""
    if B <= 0:
        return f"B={B} must be positive"
    if S <= 0 or S % 64:
        return f"S={S} must be a positive multiple of 64 (a row tile spans two batch elements)"
    if C <= 0 or C % 64:
        return f"C={C} must be a positive multiple of 64 (the kernel's K chunks)"
    if N <= 0 or N % 8:
        return f"N={N} must be a positive multiple of 8"
    return None


def gn_proj_fwd(x, w, b, weight, bias):
    """GroupNorm affine + projection; kernel on CUDA, plain version on CPU."""
    if not x.is_cuda:
        return gn_proj_reference(x, w, b, weight, bias)
    kernels.require_no_grad("gn_proj_fwd", x, w, b, weight, bias)
    kernels.require_cuda_bf16("gn_proj_fwd", x, weight)
    kernels.require(x.ndim == 3, "gn_proj_fwd: x must be (B, S, C)")
    B, S, C = x.shape
    N = weight.shape[0]
    err = gn_shape_error(B, S, C, N)
    kernels.require(err is None, f"gn_proj_fwd: {err}")
    kernels.require(weight.shape == (N, C), f"gn_proj_fwd: weight {tuple(weight.shape)}")
    kernels.require_cuda_f32("gn_proj_fwd", x.device, w, b, bias)
    kernels.require(w.shape == (B, C) and b.shape == (B, C) and bias.shape == (N,),
                    "gn_proj_fwd: affine must be (B, C) and bias (N,)")
    kernels.require(all(t.data_ptr() % 16 == 0 for t in (w, b, bias)),
                    "gn_proj_fwd: 16-byte aligned affine and bias (bulk copies)")
    out = torch.empty((B, S, N), dtype=x.dtype, device=x.device)
    code = kernels.library().psd_gn_proj_fwd(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        out.data_ptr(), B, S, C, N, kernels.stream_ptr(x))
    kernels.check(code, "gn_proj_fwd")
    kernels.launch_counts["gn_proj"] += 1
    return out
