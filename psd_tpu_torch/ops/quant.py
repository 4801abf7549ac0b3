"""Symmetric int8 quantization, the W8A8 matmul and the W8A8 3×3 convolution.

Counterpart of `psd_tpu/ops/quant.py` (`quant_rows`, `quant_cols`,
`qdense`, `qconv3x3`), what the int8 attention op, the int8 VAE decoder and
the int8 UNet (`UNetConfig.quant="int8"`) use. The scheme is psd_tpu's:
symmetric scales `max(amax, 1e-8) · (1/127)` in fp32, round half to even
(`torch.round`, as `jnp.round`), dequant in an fp32 epilogue; per-row
activation scales for matmuls, per-sample ones for convs, per-output-channel
weight scales. XLA math in psd_tpu, plain torch here.

A row-parallel site cut over tp (`parallel/mesh.py::cut_tp_`) holds K/tp
of each row's K columns on each rank: `qdense(group=, tp=)` computes the
whole site's function there. Its depth gate reads the whole K; each row's
scale is the amax over the whole K (the local amax, then an all-reduce MAX
over the tp group: exact), and the int32 partial products are summed over
the group in int32 (exact) before the fp32 epilogue, so every rank gets
the whole site's accumulator and output bit for bit.

`qdense` and `qconv3x3` take their weights already quantized (int8, output
channel first, and one fp32 scale per output channel): the models compute
them once from the fp32 weights (`models.layers.quantize_int8_weights_`),
where psd_tpu quantizes the fp32 parameter tree inline. The integer
products are `torch._int_mm` (cuBLASLt's int8 GEMM on the card) in int32:
the same exact accumulators as psd_tpu's int32 dot and convolution, on the
CPU and the card alike. PyTorch has no int8 convolution, so the conv runs
as nine such products, one per 3×3 tap, summed in int32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..parallel import mesh

EPS = 1e-8
INV127 = 1.0 / 127.0

# psd_tpu's depth below which a matmul stays in bf16: int8 did not pay on
# the TPU it was measured on (psd_tpu/ops/quant.py:43-47); kept so that the
# port computes the same function
MIN_QUANT_K = 512

# torch._int_mm on the card takes an (M, K) × (K, N) product only for
# M > 16 and K, N multiples of 8; fewer rows are padded with zero rows
INT_MM_MIN_ROWS = 17


def quant_worthwhile(k: int) -> bool:
    """Whether a contraction of depth `k` takes the int8 product."""
    return k >= MIN_QUANT_K


def int_mm(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of int8 `xq` (M, K) and int8 `wq` (N, K) → (M, N).
    Fewer than INT_MM_MIN_ROWS rows are padded with zero rows and the
    padding sliced off: the same product at any M."""
    M = xq.shape[0]
    if M < INT_MM_MIN_ROWS:
        xq = F.pad(xq, (0, 0, 0, INT_MM_MIN_ROWS - M))
    return torch._int_mm(xq.contiguous(), wq.t())[:M]  # (K, N), column-major


def quant_rows(x: torch.Tensor, group=None):
    """Per-row int8 quantization of a (..., K) tensor → (q int8, scale fp32
    (..., 1)) with x ≈ q · scale. With `group`, x holds this rank's columns
    of rows whose K the group's ranks split: the amax is the whole row's."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    if group is not None:
        mesh.tp_all_reduce(amax, group, dist.ReduceOp.MAX)
    scale = amax.clamp_min(EPS) * INV127
    return torch.round(xf / scale).to(torch.int8), scale


def quant_samples(x: torch.Tensor):
    """Per-sample int8 quantization of a (B, ...) tensor → (q int8, scale
    fp32 (B, 1, ..., 1)): one scale over each sample's every element."""
    xf = x.float()
    scale = xf.abs().amax(dim=tuple(range(1, x.ndim)), keepdim=True).clamp_min(EPS) * INV127
    return torch.round(xf / scale).to(torch.int8), scale


def quant_cols(w: torch.Tensor, axis: int = -1):
    """Per-output-channel int8 quantization; `axis` is the output axis, the
    scale keeps it and reduces every other axis (keepdim)."""
    wf = w.float()
    axis = axis % w.ndim
    red = tuple(i for i in range(w.ndim) if i != axis)
    scale = wf.abs().amax(dim=red, keepdim=True).clamp_min(EPS) * INV127
    return torch.round(wf / scale).to(torch.int8), scale


def qdense(x: torch.Tensor, w: torch.Tensor, wq: Optional[torch.Tensor] = None,
           sw: Optional[torch.Tensor] = None, b: Optional[torch.Tensor] = None,
           out_dtype: Optional[torch.dtype] = None, group=None, tp: int = 1) -> torch.Tensor:
    """x (..., K) times a Linear's weight, psd_tpu's `qdense`: below
    MIN_QUANT_K the `out_dtype` product of x and `w` (N, K), summed in fp32,
    plus b in fp32; from it on, per-row activation scales, the int32 product
    with the int8 weights `wq` (N, K) and their per-N scales `sw` (N,), then
    `acc · sx · sw + b` in fp32. The result in `out_dtype` (x's by default).
    With `group` (a row-parallel site cut over `tp` ranks: x, w and wq hold
    this rank's K/tp columns) the same function of the whole K: the gate at
    K·tp, the whole rows' scales, the int32 accumulators summed over the
    group (below the gate, the products summed in fp32), then the bias."""
    out_dtype = out_dtype or x.dtype
    K = x.shape[-1]
    if not quant_worthwhile(K * (tp if group is not None else 1)):
        out = F.linear(x.to(out_dtype), w.to(out_dtype)).float()
        if group is not None:
            mesh.tp_all_reduce(out, group)
    else:
        if wq is None or sw is None:
            raise ValueError(f"qdense at K={K} >= {MIN_QUANT_K} needs the int8 weights")
        xq, sx = quant_rows(x.reshape(-1, K), group)
        acc = int_mm(xq, wq)
        if group is not None:
            mesh.tp_all_reduce(acc, group)
        out = (acc.float() * sx * sw.float().reshape(1, -1)).reshape(x.shape[:-1] + (-1,))
    if b is not None:
        out = out + b.float()
    return out.to(out_dtype)


def qconv3x3(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
             b: Optional[torch.Tensor] = None, stride: int = 1,
             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """int8 SAME 3×3 conv, NHWC: per-sample activation scale over (H, W, C),
    the weights' per-Cout scale `sw` (Cout,), integer product, then
    `acc · (sx · sw) + b` in fp32 and the cast to `out_dtype`."""
    out_dtype = out_dtype or x.dtype
    xq, sx = quant_samples(x)  # sx (B, 1, 1, 1)
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
            part = int_mm(x_tap, taps[dy, dx])
            acc = part if acc is None else acc.add_(part)
    return acc.reshape(B, Ho, Wo, -1)
