"""Gated triple-pathway cross-attention: kernel wrapper and plain version.

Counterpart of `psd_tpu/ops/split3.py`:

    out = g_anat·softmax(qKaᵀ·s)Va + g_dis·softmax(qKdᵀ·s)Vd + δ·softmax(qKδᵀ·s)Vδ

The banks hold 16 tokens each (the AOE, image and delta segments of the
conditioning). The gates are per-site constants, plain kernel arguments.
δ (the steering scale) is a runtime scalar, a 0-d fp32 tensor on q's
device (`kernels.device_scalar`, made once at the UNet's boundary) that the
kernel reads from device memory (psd_tpu's kernel reads it from SMEM,
`psd_tpu/ops/split3.py:116,128`): a captured program replays at whatever δ
was last written into it, and nothing on the way calls `float()` on it.
Every entry here takes that tensor and checks it. The plain version
multiplies each pathway by its factor rounded to the compute dtype, the two
gates and δ alike, as psd_tpu's `_xla_split3` does (a Python gate times a
bf16 array is a bf16 product in JAX; `delta_scale.astype(z.dtype)`); the
kernel keeps all three fp32 against its fp32 accumulators, as psd_tpu's
Pallas kernel does. The kernel is `csrc/split3.cu`: persistent, q streamed
through a TMA ring in items of R rows × G heads of one batch element, each
block's run of items sharing the group's banks in shared memory;
`split3_plan` picks (R, G, ring depth, blocks an SM).

`split3_attention` is the entry the model calls: with gradients wanted it
goes through `Split3Attention`, an autograd.Function whose forward is the
kernel and whose backward recomputes through the plain version with
autograd, as `psd_tpu/ops/split3.py:143-151` back-propagates through XLA
math (the banks are 16 tokens, so the recomputation is small). The TPU
package has no split3 backward kernel, and neither has this one.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch

from . import kernels
from .attention import attention_reference


def rounded_gate(gate: float, dtype: torch.dtype) -> float:
    """A Python gate rounded to `dtype`, the factor JAX multiplies a `dtype`
    array by (a weak-typed Python float takes the array's dtype)."""
    return torch.tensor(gate, dtype=dtype).item()


def gated_sum(z_anat, z_dis, z_delta, delta, anat_gate: float, dis_gate: float):
    """g_anat·z_anat + g_dis·z_dis + δ·z_delta in the pathways' dtype, each
    factor rounded to it first, as psd_tpu's plain route does
    (`psd_tpu/ops/split3.py:62-66`, `psd_tpu/models/layers.py:469-474`)."""
    dt = z_anat.dtype
    z = rounded_gate(anat_gate, dt) * z_anat + rounded_gate(dis_gate, dt) * z_dis
    return z + delta.to(dt) * z_delta


def split3_reference(q, k_anat, v_anat, k_dis, v_dis, k_delta, v_delta,
                     delta_scale, anat_gate: float, dis_gate: float,
                     scale: Optional[float] = None):
    """Plain version (psd_tpu/ops/split3.py::_xla_split3): three plain
    attentions, combined in q.dtype by `gated_sum`; δ a 0-d fp32 tensor on
    q's device."""
    kernels.require_device_scalar("split3_reference", delta_scale, q)
    return gated_sum(attention_reference(q, k_anat, v_anat, scale),
                     attention_reference(q, k_dis, v_dis, scale),
                     attention_reference(q, k_delta, v_delta, scale),
                     delta_scale, anat_gate, dis_gate)


# csrc/split3.cu's shared memory: a ring stage holds an item's q as
# 64-column boxes of R rows × 128 bytes, the banks six such sets of 16-row
# boxes; then 8 bytes of mbarrier a stage, 8 for the banks' and 1024 of
# alignment, within what a block may take: 232448 bytes as the one block of
# an SM, 115712 as one of two (half the SM's 233472, less the 1024 each
# block reserves).
SPLIT3_SMEM_MAX, SPLIT3_SMEM_MAX_2, SPLIT3_MAX_STAGES = 232448, 115712, 4


def _split3_smem(R: int, G: int, stages: int, D: int) -> int:
    boxes = (G * D + 63) // 64
    return stages * boxes * R * 128 + 6 * boxes * 16 * 128 + 8 * stages + 8 + 1024


def _split3_fit(H: int, D: int, smem_max: int) -> Optional[Tuple[int, int, int]]:
    for R in (64, 32, 16):
        for G in range(H, 0, -1):
            if H % G or (G != H and (G * D) % 64):
                continue
            for stages in range(SPLIT3_MAX_STAGES, 1, -1):
                if _split3_smem(R, G, stages, D) <= smem_max:
                    return R, G, stages
    return None


@functools.lru_cache(maxsize=None)
def split3_plan(H: int, D: int, rows: int = 0, sms: int = 0
                ) -> Optional[Tuple[int, int, int, int]]:
    """(rows R, heads G, ring stages, blocks an SM) of the kernel's work
    items, or None when nothing fits: R = 64 rows if it fits (else 32, 16),
    G the largest divisor of H whose banks fit beside the ring, and the
    deepest ring (4 to 2 stages) that fits. A group smaller than H must span
    whole 64-column boxes (G·D % 64 == 0), so that its TMA stores write no
    other group's columns. Two blocks an SM, each in half its shared memory,
    where D ≤ 80 and one block an SM would get fewer than two of the `rows`
    (= B·S) rows' items on `sms` SMs. On the main path: D = 40, H = 8 →
    (64, 8, 4, 1) at (8, 4096); D = 80 → (32, 4, 2, 2) at (8, 1024); D = 160
    → (64, 2, 4, 1)."""
    plan = _split3_fit(H, D, SPLIT3_SMEM_MAX)
    if plan is None:
        return None
    R, G, _ = plan
    if D <= 80 and rows // R * (H // G) < 2 * sms:
        two = _split3_fit(H, D, SPLIT3_SMEM_MAX_2)
        if two is not None:
            return two + (2,)
    return plan + (1,)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def split3_shape_error(B: int, S: int, H: int, D: int, lens: Sequence[int]) -> Optional[str]:
    """Why the kernel does not take q (B, S, H, D) with banks of `lens`
    tokens, or None when it does: banks of 1..16 tokens (three 16-key
    slices of one 48-key product), 16-byte head slices, the head dims the
    kernel is built for, items of 64 rows at most, and a plan that fits
    (split3_plan; every H·D up to 904, and every shape the UNet routes: H = 8,
    D = 40, 80, 160; at H = 8 the banks of D = 120, 136, 152 do not fit)."""
    if B <= 0 or H <= 0:
        return f"B={B} and H={H} must be positive"
    if len(lens) != 3 or not all(1 <= n <= 16 for n in lens):
        return f"bank lengths {tuple(lens)} must be 1..16"
    if D % 8 or not 24 <= D <= 160:
        return f"head dim {D} must be a multiple of 8 in 24..160"
    if S <= 0 or S % 64:
        return f"sequence length {S} must be a positive multiple of 64"
    if split3_plan(H, D) is None:
        return f"H={H}, D={D}: no head group's banks fit in shared memory beside the ring"
    return None


def split3_fwd(q, k_anat, v_anat, k_dis, v_dis, k_delta, v_delta,
               delta_scale, anat_gate: float, dis_gate: float,
               scale: Optional[float] = None):
    """q (B,S,H,D), banks (B,K,H,D), δ (a 0-d fp32 tensor on q's device,
    `kernels.device_scalar`) → (B,S,H,D); kernel on CUDA, plain on CPU."""
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    banks = (k_anat, v_anat, k_dis, v_dis, k_delta, v_delta)
    kernels.require_device_scalar("split3_fwd", delta_scale, q)
    if not q.is_cuda:
        return split3_reference(q, *banks, delta_scale, anat_gate, dis_gate, scale)
    B, S, H, D = q.shape
    kernels.require_no_grad("split3_fwd", q, *banks)
    kernels.require_cuda_bf16("split3_fwd", q, *banks)
    for kb, vb in zip(banks[0::2], banks[1::2]):
        kernels.require(kb.shape == vb.shape and kb.shape[0] == B
                        and kb.shape[2:] == (H, D),
                        f"split3_fwd: bank shape {tuple(kb.shape)}/{tuple(vb.shape)}")
    lens = [kb.shape[1] for kb in banks[0::2]]
    err = split3_shape_error(B, S, H, D, lens)
    kernels.require(err is None, f"split3_fwd: {err}")
    out = torch.empty_like(q)
    lib = kernels.library()
    code = lib.psd_split3_fwd(q.data_ptr(), *[t.data_ptr() for t in banks],
                              out.data_ptr(), B, S, H, D, *lens,
                              float(anat_gate), float(dis_gate), delta_scale.data_ptr(),
                              scale, *split3_plan(H, D, B * S, _sm_count(q.device)),
                              kernels.stream_ptr(q))
    kernels.check(code, "split3_fwd")
    kernels.launch_counts["split3"] += 1
    return out


class Split3Attention(torch.autograd.Function):
    """split3 with the kernel forward and a plain-version backward."""

    @staticmethod
    def forward(ctx, q, k_anat, v_anat, k_dis, v_dis, k_delta, v_delta,
                delta_scale, anat_gate, dis_gate, scale):
        ctx.save_for_backward(q, k_anat, v_anat, k_dis, v_dis, k_delta, v_delta)
        ctx.consts = (delta_scale, anat_gate, dis_gate, scale)
        return split3_fwd(q, k_anat, v_anat, k_dis, v_dis, k_delta, v_delta,
                          delta_scale, anat_gate, dis_gate, scale)

    @staticmethod
    def backward(ctx, dout):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            out = split3_reference(*ins, *ctx.consts)
            grads = torch.autograd.grad(out, ins, dout)
        return (*grads, None, None, None, None)


def split3_attention(q, k_anat, v_anat, k_dis, v_dis, k_delta, v_delta,
                     delta_scale, anat_gate: float, dis_gate: float,
                     scale: Optional[float] = None):
    """The model's split3 entry: the autograd.Function when gradients are
    wanted, else the forward wrapper alone. δ is a 0-d fp32 tensor on q's
    device (`kernels.device_scalar`)."""
    args = (q, k_anat, v_anat, k_dis, v_dis, k_delta, v_delta)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return Split3Attention.apply(*args, delta_scale, anat_gate, dis_gate, scale)
    return split3_fwd(*args, delta_scale, anat_gate, dis_gate, scale)
