"""Symmetric int8 quantization and the W8A8 3×3 convolution.

Counterpart of `psd_tpu/ops/quant.py` (`quant_rows`, `quant_cols`,
`qconv3x3`), the part the int8 attention op and the int8 VAE decoder use.
The scheme is psd_tpu's: symmetric scales `max(amax, 1e-8) · (1/127)` in
fp32, round half to even (`torch.round`, as `jnp.round`), dequant in an fp32
epilogue. XLA math in psd_tpu, plain torch here.

`qconv3x3` takes its weights already quantized (int8 OIHW and one fp32 scale
per output channel): the VAE computes them once from the fp32 weights
(`models.layers.quantize_int8_weights_`), where psd_tpu quantizes the fp32
parameter tree inline. PyTorch has no int8 convolution, so the integer
product runs as nine int8 × int8 → int32 matrix products, one per 3×3 tap
(`torch._int_mm`, cuBLASLt's int8 GEMM on the card), summed in int32: the
same exact accumulator as psd_tpu's int32 convolution, on the CPU and the
card alike.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

EPS = 1e-8
INV127 = 1.0 / 127.0


def quant_rows(x: torch.Tensor):
    """Per-row int8 quantization of a (..., K) tensor → (q int8, scale fp32
    (..., 1)) with x ≈ q · scale."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(EPS) * INV127
    return torch.round(xf / scale).to(torch.int8), scale


def quant_cols(w: torch.Tensor, axis: int = -1):
    """Per-output-channel int8 quantization; `axis` is the output axis, the
    scale keeps it and reduces every other axis (keepdim)."""
    wf = w.float()
    axis = axis % w.ndim
    red = tuple(i for i in range(w.ndim) if i != axis)
    scale = wf.abs().amax(dim=red, keepdim=True).clamp_min(EPS) * INV127
    return torch.round(wf / scale).to(torch.int8), scale


def qconv3x3(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
             b: Optional[torch.Tensor] = None, stride: int = 1,
             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """int8 SAME 3×3 conv, NHWC: per-sample activation scale over (H, W, C),
    the weights' per-Cout scale `sw` (Cout,), integer product, then
    `acc · (sx · sw) + b` in fp32 and the cast to `out_dtype`."""
    out_dtype = out_dtype or x.dtype
    xf = x.float()
    sx = xf.abs().amax(dim=(1, 2, 3), keepdim=True).clamp_min(EPS) * INV127  # (B,1,1,1)
    xq = torch.round(xf / sx).to(torch.int8)
    acc = int8_conv3x3(xq, wq, stride)
    out = acc.float() * (sx * sw.float().reshape(1, 1, 1, -1))
    if b is not None:
        out = out + b.float()
    return out.to(out_dtype)


def int8_conv3x3(xq: torch.Tensor, wq: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Exact int32 SAME 3×3 conv of int8 NHWC `xq` with int8 OIHW `wq`: one
    (B·Ho·Wo, Cin) × (Cin, Cout) int8 product per tap, accumulated in int32.
    Cin and Cout must be multiples of 8 (the int8 GEMM's constraint)."""
    B, H, W, C = xq.shape
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    xp = F.pad(xq, (0, 0, 1, 1, 1, 1))
    taps = wq.permute(2, 3, 0, 1).contiguous()  # (3, 3, Cout, Cin)
    acc = None
    for dy in range(3):
        for dx in range(3):
            x_tap = xp[:, dy:dy + stride * (Ho - 1) + 1:stride,
                       dx:dx + stride * (Wo - 1) + 1:stride].reshape(-1, C)
            part = torch._int_mm(x_tap, taps[dy, dx].t())  # (Cin, Cout), column-major
            acc = part if acc is None else acc.add_(part)
    return acc.reshape(B, Ho, Wo, -1)
