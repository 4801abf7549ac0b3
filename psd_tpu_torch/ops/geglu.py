"""LayerNorm fused into the projections that follow it: `ln_proj` (the
attention sites' norm + bias-free q/k/v) and `ln_geglu` (norm3 + the GEGLU
projection of the feed-forward). Kernel wrappers and plain versions.

Counterpart of `psd_tpu/ops/geglu.py`. The LayerNorm is flax's: fp32 stats,
fast variance E[x²]−μ² clamped at 0, eps 1e-5, affine in fp32, then cast to
the compute dtype. Weights are in PyTorch's Linear layout (out, in). The
kernels are `csrc/ln_proj.cu` and `csrc/ln_geglu.cu`, on the wgmma template
of `csrc/ln_gemm_sm90.cuh`: each wrapper call launches a statistics pass
(into an (M, 2) fp32 scratch it allocates) and the GEMM, and counts one
launch.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import kernels


def ln_reference(x, scale, bias, eps: float = 1e-5):
    """flax nn.LayerNorm math (fast variance, fp32 stats), output in x.dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def ln_proj_reference(x, ln_scale, ln_bias, ws, eps: float = 1e-5):
    """(M, C) → tuple of (M, N_i): LN then bias-free projections (out, in)."""
    xn = ln_reference(x, ln_scale, ln_bias, eps)
    return tuple(F.linear(xn, w.to(xn.dtype)) for w in ws)


def gelu_exact(x):
    return F.gelu(x, approximate="none")


def ln_geglu_reference(x, ln_scale, ln_bias, w0, b0, eps: float = 1e-5):
    """(M, C) → (M, N): LN, [h|g] = x̂·W0ᵀ + b0 (fp32 bias), h·gelu(g)."""
    xn = ln_reference(x, ln_scale, ln_bias, eps)
    proj = F.linear(xn, w0.to(xn.dtype)).float() + b0.float()
    h, g = proj.chunk(2, dim=-1)
    return (h * gelu_exact(g)).to(x.dtype)


def ln_shape_error(M: int, C: int, N: int) -> Optional[str]:
    """Why the LayerNorm-fused kernels do not take x (M, C) with N output
    columns (a projection's rows; GEGLU's N = W0 rows / 2), or None when
    they do: 128-row tiles, 64-column K chunks (one TMA box), and 16-byte
    rows for TMA and the bf16x2 stores. `ln_fused_ok` routes every (M, C)
    that passes (N = C or 4C)."""
    if M <= 0 or M % 128:
        return f"M={M} must be a positive multiple of 128 (the kernels' row tiles)"
    if C <= 0 or C % 64:
        return f"C={C} must be a positive multiple of 64 (the kernels' K chunks)"
    if N <= 0 or N % 8:
        return f"N={N} must be a positive multiple of 8"
    return None


def _check_ln(name, x, ln_scale, ln_bias):
    kernels.require_cuda_bf16(name, x)
    kernels.require(x.ndim == 2, f"{name}: x must be (M, C)")
    C = x.shape[1]
    kernels.require_cuda_f32(name, x.device, ln_scale, ln_bias)
    kernels.require(ln_scale.shape == (C,) and ln_bias.shape == (C,), f"{name}: LN params")
    kernels.require(ln_scale.data_ptr() % 16 == 0 and ln_bias.data_ptr() % 16 == 0,
                    f"{name}: 16-byte aligned LN params (bulk copies)")


def ln_proj_fwd(x, ln_scale, ln_bias, ws, eps: float = 1e-5):
    """LN + 1 or 3 bias-free projections of the same rows; kernel on CUDA."""
    if not x.is_cuda:
        return ln_proj_reference(x, ln_scale, ln_bias, ws, eps)
    kernels.require_no_grad("ln_proj_fwd", x, ln_scale, ln_bias, *ws)
    _check_ln("ln_proj_fwd", x, ln_scale, ln_bias)
    M, C = x.shape
    kernels.require(len(ws) in (1, 3), "ln_proj_fwd: 1 or 3 projections")
    kernels.require_cuda_bf16("ln_proj_fwd", *ws)
    N = ws[0].shape[0]
    kernels.require(all(w.shape == (N, C) for w in ws), f"ln_proj_fwd: weights must be ({N}, {C})")
    err = ln_shape_error(M, C, N)
    kernels.require(err is None, f"ln_proj_fwd: {err}")
    stats = torch.empty((M, 2), dtype=torch.float32, device=x.device)
    outs = tuple(torch.empty((M, N), dtype=x.dtype, device=x.device) for _ in ws)
    wp = [w.data_ptr() for w in ws] + [0] * (3 - len(ws))
    op = [o.data_ptr() for o in outs] + [0] * (3 - len(ws))
    code = kernels.library().psd_ln_proj_fwd(
        x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), *wp, *op, stats.data_ptr(),
        len(ws), M, C, N, float(eps), kernels.stream_ptr(x))
    kernels.check(code, "ln_proj_fwd")
    kernels.launch_counts["ln_proj"] += 1
    return outs


def ln_geglu_fwd(x, ln_scale, ln_bias, w0, b0, eps: float = 1e-5):
    """LN → GEGLU projection → h·gelu(g), (M, C) → (M, N); kernel on CUDA."""
    if not x.is_cuda:
        return ln_geglu_reference(x, ln_scale, ln_bias, w0, b0, eps)
    kernels.require_no_grad("ln_geglu_fwd", x, ln_scale, ln_bias, w0, b0)
    _check_ln("ln_geglu_fwd", x, ln_scale, ln_bias)
    M, C = x.shape
    kernels.require_cuda_bf16("ln_geglu_fwd", w0)
    N2 = w0.shape[0]
    kernels.require(w0.shape == (N2, C) and N2 % 2 == 0,
                    f"ln_geglu_fwd: W0 {tuple(w0.shape)} must be (2N, {C})")
    N = N2 // 2
    err = ln_shape_error(M, C, N)
    kernels.require(err is None, f"ln_geglu_fwd: {err}")
    kernels.require_cuda_f32("ln_geglu_fwd", x.device, b0)
    kernels.require(b0.shape == (N2,) and b0.data_ptr() % 16 == 0,
                    "ln_geglu_fwd: b0 must be (2N,), 16-byte aligned")
    stats = torch.empty((M, 2), dtype=torch.float32, device=x.device)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    code = kernels.library().psd_ln_geglu_fwd(
        x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), w0.data_ptr(),
        b0.data_ptr(), out.data_ptr(), stats.data_ptr(), M, C, N, float(eps),
        kernels.stream_ptr(x))
    kernels.check(code, "ln_geglu_fwd")
    kernels.launch_counts["ln_geglu"] += 1
    return out
