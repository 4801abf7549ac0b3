"""Folded GroupNorm affine fused into the projection that follows it
(Transformer2D's GroupNorm → proj_in): kernel wrapper and plain version.

Counterpart of `psd_tpu/ops/gnproj.py`. The GroupNorm statistics reduce to a
per-(batch, channel) affine (w, b) (`ops/norms.py::group_norm_fold`, plain
torch); given it,

    out = bf16(x·w + b in fp32) · Wᵀ, fp32 accumulation, + bias (fp32) → x.dtype

W is in PyTorch's Linear layout (N, C). The kernel is `csrc/gn_proj.cu`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import kernels


def gn_proj_reference(x, w, b, weight, bias):
    """(B, S, C) x, (B, C) fp32 affine, (N, C) weight, (N,) bias → (B, S, N)
    (psd_tpu/ops/gnproj.py::_xla_reference, one output)."""
    xa = (x.float() * w.float()[:, None, :] + b.float()[:, None, :]).to(x.dtype)
    out = F.linear(xa, weight.to(x.dtype)).float() + bias.float()
    return out.to(x.dtype)


def gn_proj_fwd(x, w, b, weight, bias):
    """GroupNorm affine + projection; kernel on CUDA, plain version on CPU."""
    if not x.is_cuda:
        return gn_proj_reference(x, w, b, weight, bias)
    kernels.require_cuda_bf16("gn_proj_fwd", x, weight)
    kernels.require(x.ndim == 3, "gn_proj_fwd: x must be (B, S, C)")
    B, S, C = x.shape
    N = weight.shape[0]
    kernels.require(S % 64 == 0 and C % 32 == 0 and N % 64 == 0,
                    f"gn_proj_fwd: S={S} must be a multiple of 64, C={C} of 32, N={N} of 64")
    kernels.require(weight.shape == (N, C), f"gn_proj_fwd: weight {tuple(weight.shape)}")
    kernels.require_cuda_f32("gn_proj_fwd", x.device, w, b, bias)
    kernels.require(w.shape == (B, C) and b.shape == (B, C) and bias.shape == (N,),
                    "gn_proj_fwd: affine must be (B, C) and bias (N,)")
    out = torch.empty((B, S, N), dtype=x.dtype, device=x.device)
    code = kernels.library().psd_gn_proj_fwd(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        out.data_ptr(), B, S, C, N, kernels.stream_ptr(x))
    kernels.check(code, "gn_proj_fwd")
    kernels.launch_counts["gn_proj"] += 1
    return out
