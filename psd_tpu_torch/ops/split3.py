"""Gated triple-pathway cross-attention: kernel wrapper and plain version.

Counterpart of `psd_tpu/ops/split3.py`:

    out = g_anat·softmax(qKaᵀ·s)Va + g_dis·softmax(qKdᵀ·s)Vd + δ·softmax(qKδᵀ·s)Vδ

The banks hold 16 tokens each (the AOE, image and delta segments of the
conditioning). The gates are per-site constants and δ (the steering scale)
a runtime scalar; both are plain kernel arguments, so changing either never
rebuilds anything. The kernel is `csrc/split3.cu`.

`split3_attention` is the entry the model calls: with gradients wanted it
goes through `Split3Attention`, an autograd.Function whose forward is the
kernel and whose backward recomputes through the plain version with
autograd, as `psd_tpu/ops/split3.py:143-151` back-propagates through XLA
math (the banks are 16 tokens, so the recomputation is small). The TPU
package has no split3 backward kernel, and neither has this one.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import kernels
from .attention import attention_reference


def split3_reference(q, k_anat, v_anat, k_dis, v_dis, k_delta, v_delta,
                     delta_scale: float, anat_gate: float, dis_gate: float,
                     scale: Optional[float] = None):
    """Plain version (psd_tpu/ops/split3.py::_xla_split3): three plain
    attentions, combined in q.dtype."""
    z = anat_gate * attention_reference(q, k_anat, v_anat, scale)
    z = z + dis_gate * attention_reference(q, k_dis, v_dis, scale)
    return z + float(delta_scale) * attention_reference(q, k_delta, v_delta, scale)


def split3_fwd(q, k_anat, v_anat, k_dis, v_dis, k_delta, v_delta,
               delta_scale: float, anat_gate: float, dis_gate: float,
               scale: Optional[float] = None):
    """q (B,S,H,D), banks (B,K,H,D) → (B,S,H,D); kernel on CUDA, plain on CPU."""
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    banks = (k_anat, v_anat, k_dis, v_dis, k_delta, v_delta)
    if not q.is_cuda:
        return split3_reference(q, *banks, delta_scale, anat_gate, dis_gate, scale)
    B, S, H, D = q.shape
    kernels.require_cuda_bf16("split3_fwd", q, *banks)
    lens = []
    for kb, vb in zip(banks[0::2], banks[1::2]):
        kernels.require(kb.shape == vb.shape and kb.shape[0] == B
                        and kb.shape[2:] == (H, D),
                        f"split3_fwd: bank shape {tuple(kb.shape)}/{tuple(vb.shape)}")
        kernels.require(1 <= kb.shape[1] <= 16, "split3_fwd: bank length must be 1..16")
        lens.append(kb.shape[1])
    kernels.require(D % 8 == 0 and 24 <= D <= 160, f"split3_fwd: head dim {D}")
    kernels.require(S % 64 == 0, f"split3_fwd: sequence length {S} must be a multiple of 64")
    out = torch.empty_like(q)
    lib = kernels.library()
    code = lib.psd_split3_fwd(q.data_ptr(), *[t.data_ptr() for t in banks],
                              out.data_ptr(), B, S, H, D, *lens,
                              float(anat_gate), float(dis_gate), float(delta_scale),
                              scale, kernels.stream_ptr(q))
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
                     delta_scale: float, anat_gate: float, dis_gate: float,
                     scale: Optional[float] = None):
    """The model's split3 entry: the autograd.Function when gradients are
    wanted, else the forward wrapper alone."""
    args = (q, k_anat, v_anat, k_dis, v_dis, k_delta, v_delta)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return Split3Attention.apply(*args, float(delta_scale), anat_gate, dis_gate, scale)
    return split3_fwd(*args, delta_scale, anat_gate, dis_gate, scale)
