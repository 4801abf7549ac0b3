"""Regional token merging (ToMe) for the UNet's transformer sites.

Counterpart of `psd_tpu/ops/tome.py`: an inference-only lever
(`UNetConfig.tome_ratio`), off on the exact path. Every 2×2 region of the
token grid keeps its (0, 0) token as dst and merges the `m ∈ {1, 2, 3}` of
its three src tokens that are most cosine-similar to it (ToMe for SD,
arXiv:2303.17098, with regional instead of global matching):

  * similarity: one einsum over (B, N/4, 3, C), argmin/argmax over 3 slots
    (the first index on ties, as `jnp.argmin` / `jnp.argmax`);
  * merge: dst' = mean(dst + merged srcs), kept srcs compacted in (region,
    slot) order ahead of the dst' tokens;
  * unmerge: one gather through a static permutation; merged tokens copy
    their region's dst'.

The ratio quantizes to m/4, so N - m·N/4 stays a multiple of 128 at every
real site and the attention and LayerNorm kernels keep their tile shapes.

Everything here can be captured in a CUDA graph (a served batch is one
replayed graph, `diffusion/graphs.py`): no host sync, and the static region
indices and the inverse permutation are built once per (H, W, device) on
the device, by the eager warm-up that precedes every capture (an H2D copy
from numpy inside a capture fails; `_static` raises there instead).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

MODES = ("branch", "block")


@dataclass(frozen=True)
class ToMeSpec:
    """Static ToMe settings of a model (`UNetConfig.tome_*`).

    `mode` "branch": merge / unmerge around each configured residual branch
    (self-attention always, the cross-attention query with `merge_cross`,
    the feed-forward with `merge_mlp`). "block": one merge at the
    transformer block's entry, the whole block at the merged length, one
    unmerge at its exit."""

    ratio: float = 0.0  # fraction of all N tokens merged away (0 = off)
    min_tokens: int = 4096  # only at sites with N >= this (stage 0 at 512²)
    merge_mlp: bool = False
    merge_cross: bool = False
    mode: str = "branch"

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"ToMe mode must be one of {MODES}, got {self.mode!r}")

    def r_count(self, n_tokens: int) -> int:
        """Merged-token count: the ratio quantized to m/4, m ∈ {1, 2, 3}."""
        if self.ratio <= 0.0 or n_tokens < self.min_tokens:
            return 0
        m = min(3, int(round(self.ratio * 4.0)))
        if m < 1:
            return 0
        return m * (n_tokens // 4)

    def active(self, n_tokens: int) -> bool:
        return self.r_count(n_tokens) > 0

    def merged_tokens(self, n_tokens: int) -> int:
        """The sequence length a merged branch runs at."""
        return n_tokens - self.r_count(n_tokens)


def _region_indices(H: int, W: int) -> Tuple[np.ndarray, np.ndarray]:
    """Static (dst, src) token indices per 2×2 region: dst (D,) the (0, 0)
    token of each region; src (D, 3) the other three in slot order (0, 1),
    (1, 0), (1, 1)."""
    ii, jj = np.meshgrid(np.arange(0, H, 2), np.arange(0, W, 2), indexing="ij")
    base = (ii * W + jj).reshape(-1)
    src = np.stack([base + 1, base + W, base + W + 1], axis=1)
    return base.astype(np.int32), src.astype(np.int32)


_STATIC: Dict[tuple, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}


def _static(H: int, W: int, device: torch.device):
    """(dst (D,), src (D, 3), inv (N,)) int64 on `device`, cached: inv maps
    each token id to its place in the order [dst | src flattened]."""
    key = (H, W, torch.device(device))
    if key not in _STATIC:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"ToMe's region indices for {H}×{W} on {device} are built at "
                               "the first eager call; none ran before this capture")
        dst, src = _region_indices(H, W)
        order = np.concatenate([dst, src.reshape(-1)])
        inv = np.empty_like(order)
        inv[order] = np.arange(order.size, dtype=order.dtype)
        _STATIC[key] = tuple(torch.as_tensor(a.astype(np.int64), device=device)
                             for a in (dst, src, inv))
    return _STATIC[key]


class MergeInfo(NamedTuple):
    """One block's merge (`build_merge`), reused by every wrapped branch."""

    dst_idx: torch.Tensor  # (D,)
    src_idx: torch.Tensor  # (D, 3)
    merge_mask: torch.Tensor  # (B, D, 3) bool: which src slots merge into dst
    gather_map: torch.Tensor  # (B, N): each token's place in the merged sequence
    m: int


def build_merge(x: torch.Tensor, H: int, W: int, r_count: int) -> MergeInfo:
    """The merge of one transformer block, from its input x (B, N, C), N =
    H·W with H and W even, r_count = m·N/4 merged tokens, m ∈ {1, 2, 3}."""
    B, N, C = x.shape
    if N != H * W or H % 2 or W % 2:
        raise ValueError(f"ToMe needs N = H·W with H, W even; got N={N}, H={H}, W={W}")
    D = N // 4
    m, rem = divmod(r_count, D)
    if rem or not 1 <= m <= 3:
        raise ValueError(f"r_count {r_count} is not m·{D} with m in 1..3")
    dst_idx, src_idx, inv = _static(H, W, x.device)
    slots = torch.arange(3, device=x.device)
    if m == 3:  # every src merges: no data-dependent choice
        merge_mask = torch.ones((B, D, 3), dtype=torch.bool, device=x.device)
    else:
        xf = x.float()
        mnorm = xf * torch.rsqrt((xf * xf).sum(-1, keepdim=True) + 1e-6)
        sim = torch.einsum("bdkc,bdc->bdk", mnorm[:, src_idx], mnorm[:, dst_idx])
        if m == 2:  # the least similar src survives
            merge_mask = slots != sim.argmin(-1, keepdim=True)
        else:
            merge_mask = slots == sim.argmax(-1, keepdim=True)

    # merged layout: [kept srcs in (region, slot) order (D·(3-m)) | dst' (D)]
    n_keep_src = D * (3 - m)
    kept = ~merge_mask
    rank_in_region = kept.to(torch.int64).cumsum(-1) - 1
    region = torch.arange(D, device=x.device)[None, :, None]
    src_pos = torch.where(kept, region * (3 - m) + rank_in_region, n_keep_src + region)
    dst_pos = (n_keep_src + torch.arange(D, device=x.device))[None, :].expand(B, D)
    vals = torch.cat([dst_pos, src_pos.reshape(B, -1)], dim=1)
    return MergeInfo(dst_idx, src_idx, merge_mask, vals[:, inv], m)


def merge(x: torch.Tensor, mi: MergeInfo) -> torch.Tensor:
    """(B, N, C) → (B, N - m·N/4, C): the kept srcs, then each region's dst'."""
    B, N, C = x.shape
    D, m = mi.dst_idx.shape[0], mi.m
    xd = x[:, mi.dst_idx].float()
    xs = x[:, mi.src_idx]  # (B, D, 3, C)
    maskf = mi.merge_mask[..., None].float()
    dst_out = (xd + (xs.float() * maskf).sum(2)) / (1.0 + m)
    if m == 3:
        return dst_out.to(x.dtype)
    if m == 2:  # one kept slot a region
        keep_slot = (~mi.merge_mask).to(torch.uint8).argmax(-1)  # (B, D)
        x_keep = torch.take_along_dim(xs, keep_slot[:, :, None, None], dim=2)
    else:  # two kept slots a region, in ascending slot order
        merged_slot = mi.merge_mask.to(torch.uint8).argmax(-1)
        kept2 = torch.stack([(merged_slot == 0).long(), 2 - (merged_slot == 2).long()], -1)
        x_keep = torch.take_along_dim(xs, kept2[..., None], dim=2)
    return torch.cat([x_keep.reshape(B, -1, C).to(x.dtype), dst_out.to(x.dtype)], dim=1)


def unmerge(y: torch.Tensor, mi: MergeInfo) -> torch.Tensor:
    """(B, N - m·N/4, C) → (B, N, C): merged tokens copy their region's dst'."""
    return torch.take_along_dim(y, mi.gather_map[:, :, None], dim=1)


def merged_call(fn, x: torch.Tensor, mi: MergeInfo) -> torch.Tensor:
    """unmerge(fn(merge(x))): ToMe around one residual branch."""
    return unmerge(fn(merge(x, mi)), mi)
