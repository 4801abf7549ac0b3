"""Data and tensor parallelism over torch.distributed: one process per card.

Counterpart of `psd_tpu/parallel/mesh.py`. psd_tpu is one controller over a
`Mesh(dp, fsdp, tp)`: the batch's dim 0 is split over ("dp", "fsdp"), the
state is fsdp-sharded on each parameter's largest divisible dim, XLA
all-reduces the gradients and each Pallas kernel `shard_map`s itself over
the batch axes (and the head axis under tp). The port runs one process per
rank, started by `torchrun`: the process is the shard, so each rank runs
the unchanged kernels on its own rows and heads, and `shard_map_batch0`,
`kernel_batch_axes` and `constrain_batch` have no counterpart. The mesh is
a `DeviceMesh` of shape (dp, fsdp), or (dp, fsdp, tp) when tp > 1; the
train state goes under DDP (fsdp = 1) or FSDP2 (fsdp > 1, HSDP over the
2-D mesh; `train/trainer.py::shard_train_state`).

  * Rank order: tp innermost, as psd_tpu's `reshape(dp, fsdp, tp)`: rank =
    (dp_index · fsdp + fsdp_index) · tp + tp_index.
  * A rank's rows: its (dp, fsdp) position i = dp_index · fsdp + fsdp_index
    owns the i-th contiguous block of dim 0, as `P(("dp", "fsdp"))` lays
    the rows out; the tp ranks of a group hold the same rows.
  * `fsdp_shard_dim` is `fsdp_param_spec`'s rule (the largest dim that
    divides and holds at least two rows a rank); where no dim qualifies
    psd_tpu replicates the parameter, and FSDP2, which shards every
    parameter, takes its default Shard(0), padded.
  * tp: `tp_param_dim` is psd_tpu's `tp_param_spec` on the port's names,
    and `shard_tp_` cuts the UNet's transformer sites in place to the
    rank's heads and columns, Megatron-style (TP_CUTS): to_q/k/v/k_dis/v_dis
    column-parallel, to_out_0 and the feed-forward's net_2 row-parallel (a
    product without bias, an all-reduce over the tp group, then the whole
    bias), net_0_proj's two GEGLU halves cut alike (psd_tpu's
    `constrain_tp_geglu`), so each rank's packed [h_r ; g_r] keeps the
    LN → GEGLU kernel's interface; an int8 site's int8 weights and scales,
    set from the whole fp32 weights, are cut with it. A cut site runs only
    inside `tp_scope` of the mesh it was cut for (`DADD.sample(mesh=)` and
    the train step enter it) and raises anywhere else. In training
    Megatron's f and g (`copy_to_tp`, `reduce_from_tp`) carry the
    gradients across the cut: the replicated stream's and every replicated
    parameter's gradient is whole on every tp rank, each cut parameter's
    is its slice's. `tp_cuts` names the cut parameters, `tp_slice` cuts a
    whole tensor as `cut_tp_` does and `tp_gather` puts the slices back
    together (optimizer state, EMA, checkpoints).

A DTensor's values are read and written through `local` (its shard; a plain
tensor is its own), `local_part` cuts a full tensor to another's shard, and
`full` gathers a shard back (a collective: every rank calls it).

Sampling and serving (`DADD.sample(mesh=)`, `GenerationServer(mesh=)`)
split the batch as psd_tpu's `batch_sharding` does and replicate the
model outside its tp sites: each rank runs its rows (`batch_rows`),
`gather_rows` puts the rows back together into the global batch on every
rank, and `broadcast` hands rank 0's tensors to the others.
"""

from __future__ import annotations

import contextlib
import os
from contextvars import ContextVar
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Shard

# a collective that waits longer fails the run instead of hanging its ranks
TIMEOUT_S = 600


@dataclass(frozen=True)
class MeshConfig:
    dp: int = -1  # -1 → every rank the other axes leave
    fsdp: int = 1
    tp: int = 1

    def resolve(self, world_size: int) -> "MeshConfig":
        """psd_tpu's rule, with every rank placed: dp · fsdp · tp must be
        the world size (a rank with no place in the mesh has nothing to
        do)."""
        if self.fsdp < 1 or self.tp < 1 or self.dp == 0 or self.dp < -1:
            raise ValueError(f"mesh dp={self.dp} fsdp={self.fsdp} tp={self.tp}: dp is -1 or "
                             "≥ 1, fsdp and tp ≥ 1")
        inner = self.fsdp * self.tp
        dp = world_size // inner if self.dp == -1 else self.dp
        if dp < 1 or dp * inner != world_size:
            need = max(dp, 1) * inner
            raise ValueError(
                f"mesh dp={self.dp} fsdp={self.fsdp} tp={self.tp} needs {need} ranks, the world "
                f"has {world_size}: start one process per rank, e.g. `torchrun "
                f"--nproc-per-node {need} -m psd_tpu_torch.pipelines.train ...`")
        return MeshConfig(dp=dp, fsdp=self.fsdp, tp=self.tp)


def world_size() -> int:
    """The ranks of the started group, else torchrun's WORLD_SIZE, else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def launched() -> bool:
    """True under torchrun, or with a process group already started."""
    return dist.is_initialized() or "WORLD_SIZE" in os.environ


def rank_device(device_type: str) -> torch.device:
    """This rank's device: the card LOCAL_RANK names (one card a rank)."""
    if device_type != "cuda":
        return torch.device(device_type)
    local_rank, cards = int(os.environ.get("LOCAL_RANK", 0)), torch.cuda.device_count()
    if local_rank >= cards:
        raise RuntimeError(f"LOCAL_RANK {local_rank} has no card: this host has {cards}; "
                           f"start at most {cards} ranks a host")
    return torch.device("cuda", local_rank)


def create_mesh(cfg: Optional[MeshConfig] = None, device_type: str = "cuda") -> DeviceMesh:
    """The DeviceMesh over the process group, which is started from
    torchrun's environment (NCCL on cuda, gloo on cpu) unless the caller
    started one: ("dp", "fsdp"), and ("dp", "fsdp", "tp") when tp > 1, tp
    innermost (rank = (dp_index · fsdp + fsdp_index) · tp + tp_index)."""
    if device_type == "cuda":
        # before the group and the mesh, which would take LOCAL_RANK itself
        torch.cuda.set_device(rank_device("cuda"))
        torch.cuda.init()
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                timeout=timedelta(seconds=TIMEOUT_S))
    cfg = (cfg or MeshConfig()).resolve(dist.get_world_size())
    if cfg.tp == 1:
        return init_device_mesh(device_type, (cfg.dp, cfg.fsdp), mesh_dim_names=("dp", "fsdp"))
    return init_device_mesh(device_type, (cfg.dp, cfg.fsdp, cfg.tp),
                            mesh_dim_names=("dp", "fsdp", "tp"))


def tp_size(mesh: Optional[DeviceMesh]) -> int:
    """The mesh's tp axis (1 without a mesh or a tp axis)."""
    if mesh is None or "tp" not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index("tp"))


def tp_group(mesh: Optional[DeviceMesh]):
    """The process group over this rank's tp ranks, None where tp is 1."""
    return mesh.get_group("tp") if tp_size(mesh) > 1 else None


def shard_rows(n: int, dp: int, fsdp: int, dp_index: int, fsdp_index: int) -> slice:
    """The rows of dim 0 that mesh position (dp_index, fsdp_index) holds."""
    shards = dp * fsdp
    if n % shards:
        raise ValueError(f"a batch of {n} rows does not split over {dp} × {fsdp} ranks")
    k, i = n // shards, dp_index * fsdp + fsdp_index
    return slice(i * k, (i + 1) * k)


def batch_rows(mesh: Optional[DeviceMesh], n: int) -> slice:
    """This rank's rows of a global batch of n (its (dp, fsdp) position's;
    every tp rank of a group the same); all of them without a mesh."""
    if mesh is None:
        return slice(0, n)
    dp_index, fsdp_index = mesh.get_coordinate()[:2]
    return shard_rows(n, mesh.size(0), mesh.size(1), dp_index, fsdp_index)


def mesh_group(mesh: DeviceMesh):
    """The process group over every rank of `mesh`: the world, whose rank
    order is the order of `batch_rows`' blocks (each repeated over tp)
    where the mesh lays the world out as `create_mesh` does."""
    ranks = mesh.mesh.flatten().tolist()
    if ranks != list(range(dist.get_world_size())):
        raise ValueError(f"a mesh over ranks {ranks} is not the world in rank order "
                         "(build it with create_mesh)")
    return dist.group.WORLD


def gather_rows(mesh: Optional[DeviceMesh], part: torch.Tensor) -> torch.Tensor:
    """The global batch on every rank from each rank's rows of it
    (`batch_rows`' blocks of dim 0, every rank the same count): c10d's
    all_gather_into_tensor over every rank of the mesh (a collective: every
    rank calls it), then one copy of each block, its tp rank 0's (the tp
    ranks of a group hold the same rows); `part` itself without a mesh."""
    if mesh is None:
        return part
    part = part.contiguous()
    world, rest = mesh.size(), tuple(part.shape[1:])
    whole = part.new_empty((world * part.shape[0],) + rest)
    dist.all_gather_into_tensor(whole, part, group=mesh_group(mesh))
    tp = tp_size(mesh)
    if tp > 1:
        whole = whole.view((world // tp, tp) + tuple(part.shape))[:, 0].reshape((-1,) + rest)
    return whole


def broadcast(mesh: DeviceMesh, t: torch.Tensor) -> torch.Tensor:
    """`t` overwritten on every rank of the mesh with rank 0's (in place; a
    collective: every rank calls it with a tensor of one shape)."""
    dist.broadcast(t, src=0, group=mesh_group(mesh))
    return t


def shard_batch(mesh: Optional[DeviceMesh], batch):
    """This rank's rows of each array or tensor of a global batch."""
    return {k: v[batch_rows(mesh, len(v))] for k, v in batch.items()}


def fsdp_shard_dim(shape, n: int) -> Optional[int]:
    """psd_tpu's `fsdp_param_spec`: the largest dim that n divides and that
    holds at least 2n; None where it would replicate."""
    if n <= 1:
        return None
    for axis in sorted(range(len(shape)), key=lambda a: -shape[a]):
        if shape[axis] % n == 0 and shape[axis] >= 2 * n:
            return axis
    return None


def shard_placement(n: int):
    """FSDP2's `shard_placement_fn` for `fsdp_shard_dim` (None: FSDP2's
    default, Shard(0))."""
    def place(p: torch.nn.Parameter) -> Optional[Shard]:
        axis = fsdp_shard_dim(p.shape, n)
        return None if axis is None else Shard(axis)

    return place


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a view: writes reach the DTensor); a plain
    tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def local_part(full_t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """`full_t` cut to `like`'s shard, a copy on `like`'s device in its
    dtype: a DTensor of `like`'s placements when `like` is one (each shard
    as DTensor's Shard(dim) takes it: torch.chunk, trailing ranks possibly
    empty)."""
    part = full_t
    if isinstance(like, DTensor):
        coord = like.device_mesh.get_coordinate()
        for mesh_dim, placement in enumerate(like.placements):
            if isinstance(placement, Shard):
                chunks = torch.chunk(part, like.device_mesh.size(mesh_dim), dim=placement.dim)
                i = coord[mesh_dim]
                part = chunks[i] if i < len(chunks) else part.narrow(placement.dim, 0, 0)
    part = part.to(device=like.device, dtype=like.dtype, copy=True).contiguous()
    if not isinstance(like, DTensor):
        return part
    return DTensor.from_local(part, like.device_mesh, like.placements, run_check=False,
                              shape=like.shape, stride=like.stride())


def full(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a DTensor (a collective over its sharded mesh
    dim: every rank calls it); a plain tensor itself. Gathered by c10d's
    all_gather_into_tensor of torch.chunk's shards, padded to the first:
    gloo runs it on CUDA tensors, where DTensor's own `full_tensor` (a
    functional all-gather) ended both ranks with SIGSEGV, PERF.md §6."""
    if not isinstance(t, DTensor):
        return t
    sharded = [(i, p.dim) for i, p in enumerate(t.placements) if isinstance(p, Shard)]
    if not sharded:
        return t.to_local()
    (mesh_dim, dim), = sharded
    n, size = t.device_mesh.size(mesh_dim), t.shape[dim]
    step = -(-size // n)
    mine = t.to_local().movedim(dim, 0)
    padded = mine.new_zeros((step,) + tuple(mine.shape[1:]))
    padded[:mine.shape[0]] = mine
    whole = mine.new_empty((n * step,) + tuple(mine.shape[1:]))
    dist.all_gather_into_tensor(whole, padded, group=t.device_mesh.get_group(mesh_dim))
    return whole[:size].movedim(0, dim).contiguous()


def shard_group(t: torch.Tensor):
    """The process group over which `t`'s shards split it (FSDP2's fsdp
    dim), or None for a tensor every rank holds whole."""
    if not isinstance(t, DTensor):
        return None
    for mesh_dim, placement in enumerate(t.placements):
        if isinstance(placement, Shard):
            return t.device_mesh.get_group(mesh_dim)
    return None


# ---- tensor parallelism (tp axis) ------------------------------------------------------
# psd_tpu's `_TP_COL` / `_TP_ROW` (parallel/mesh.py:245-246): the flax (in,
# out) kernel is the torch (out, in) weight, so column-parallel cuts torch dim
# 0 and row-parallel dim 1
TP_COLUMN = ("to_q", "to_k", "to_v", "to_k_dis", "to_v_dis")
TP_ROW = ("to_out_0", "net_2")
# what a site of each kind cuts: parameter → (dim, halves). A tensor of
# `halves` equal parts along dim (net_0_proj's GEGLU [h ; g]) is cut in
# each part alike and kept packed [h_r ; g_r]
TP_CUTS = {
    "attention": {**{f"{n}.weight": (0, 1) for n in TP_COLUMN}, "to_out_0.weight": (1, 1)},
    "geglu": {"net_0_proj.weight": (0, 2), "net_0_proj.bias": (0, 2), "net_2.weight": (1, 1)},
}


def tp_param_dim(name: str, shape, tp: int) -> Optional[int]:
    """psd_tpu's `tp_param_spec` on a port parameter name ('...attn1.to_q.
    weight'): the torch dim the tp axis cuts, or None where it stays
    whole (the weights' dims of TP_CUTS, which the placement tests hold
    to psd_tpu's spec through it)."""
    parts = name.split(".")
    if tp <= 1 or len(parts) < 2 or parts[-1] != "weight" or len(shape) != 2:
        return None
    if parts[-2] in TP_COLUMN and shape[0] % tp == 0:
        return 0
    if parts[-2] in TP_ROW and shape[1] % tp == 0:
        return 1
    return None


@dataclass(frozen=True)
class TPCut:
    """What a cut transformer site holds: its tp group, the tp size and
    this rank's index on the tp axis."""
    group: object
    size: int
    rank: int


def tp_slice(t: torch.Tensor, dim: int, halves: int, size: int, rank: int) -> torch.Tensor:
    """The rank-th of `size` slices of whole `t` along dim, taken in each of
    its `halves` equal parts and packed (a contiguous copy)."""
    parts = t.unflatten(dim, (halves, -1))
    k = parts.shape[dim + 1] // size
    return parts.narrow(dim + 1, rank * k, k).flatten(dim, dim + 1).contiguous()


def tp_gather(part: torch.Tensor, dim: int, halves: int, cut: TPCut) -> torch.Tensor:
    """The whole tensor from every tp rank's `tp_slice` (a collective over
    the tp group: every rank of it calls it): c10d's all_gather_into_tensor,
    then each part's slices in rank order ([h_0 h_1 … ; g_0 g_1 …])."""
    mine = part.movedim(dim, 0).contiguous()
    rest = tuple(mine.shape[1:])
    whole = mine.new_empty((cut.size * mine.shape[0],) + rest)
    dist.all_gather_into_tensor(whole, mine, group=cut.group)
    whole = whole.view((cut.size, halves, -1) + rest).transpose(0, 1)
    return whole.reshape((-1,) + rest).movedim(0, dim).contiguous()


def _site_cuts(m: nn.Module):
    """(parameter name in the site, dim, halves) of each tensor the site
    `m` cuts, for the children it has."""
    for key, (dim, halves) in TP_CUTS[m.tp_kind].items():
        child = key.split(".")[0]
        if hasattr(m, child):
            yield key, dim, halves


@torch.no_grad()
def cut_tp_(module: nn.Module, cut: TPCut) -> nn.Module:
    """Cut every transformer site under `module` (a module with `tp_kind`
    "attention" or "geglu", `models/layers.py`) in place to the slice of
    tp rank `cut.rank` (TP_CUTS): the column-parallel weights on dim 0, the
    row-parallel ones on dim 1, net_0_proj's (2N, C) weight and (2N,) bias
    as two halves, each to its N/tp rows, kept packed [h_r ; g_r].
    Row-parallel biases stay whole. An int8 site's buffers are cut with its
    weight: `<site>_wq` as the weight, `<site>_sw` (one scale an output row)
    as the weight's rows, whole at a row-parallel site; they were set from
    the whole fp32 weights before the cut (`quantize_int8_weights_`), so a
    row-parallel site keeps the scales of its whole K. An attention site
    whose heads the tp size does not divide, or a feed-forward whose N it
    does not, stays whole (psd_tpu's `h_ax = None`, spattn.py:278). A
    site's `tp` is set where it was cut."""
    n, r = cut.size, cut.rank
    for prefix, m in module.named_modules():
        kind = getattr(m, "tp_kind", None)
        if kind is None:
            continue
        if m.tp is not None:
            raise RuntimeError(f"{prefix}: already cut over tp")
        if (m.num_heads if kind == "attention" else m.net_2.in_features) % n:
            continue
        rules = {}
        for key, dim, halves in _site_cuts(m):
            t = m.get_parameter(key)
            t.data = tp_slice(t.data, dim, halves, n, r)
            rules[key.split(".")[0]] = dim, halves
        for name in getattr(m, "int8_sites", ()):
            if name not in rules:
                continue
            dim, halves = rules[name]
            wq, sw = getattr(m, f"{name}_wq"), getattr(m, f"{name}_sw")
            wq.data = tp_slice(wq.data, dim, halves, n, r)
            if dim == 0:
                sw.data = tp_slice(sw.data, 0, halves, n, r)
        m.tp = cut
    return module


def tp_cuts(module: nn.Module):
    """Each parameter of `module` that `cut_tp_` cut: its name under
    `module` → (dim, halves, TPCut)."""
    out = {}
    for prefix, m in module.named_modules():
        if getattr(m, "tp_kind", None) is None or m.tp is None:
            continue
        for key, dim, halves in _site_cuts(m):
            out[f"{prefix}.{key}" if prefix else key] = dim, halves, m.tp
    return out


def shard_tp_(module: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """`cut_tp_` of `module` (the UNet) to this rank's slice of the mesh's
    tp axis; nothing where tp is 1."""
    n = tp_size(mesh)
    if n == 1:
        return module
    return cut_tp_(module, TPCut(tp_group(mesh), n, mesh.get_local_rank("tp")))


# the tp group a cut site may run in (`tp_scope`); None outside
_TP_GROUP: ContextVar = ContextVar("psd_tpu_torch_tp_group", default=None)


@contextlib.contextmanager
def tp_group_scope(group):
    """Run the model's cut sites over `group` (None: no tp group)."""
    token = _TP_GROUP.set(group)
    try:
        yield
    finally:
        _TP_GROUP.reset(token)


def tp_scope(mesh: Optional[DeviceMesh]):
    """Run the model's cut sites over the mesh's tp group (none where the
    mesh has no tp axis, or without a mesh)."""
    return tp_group_scope(tp_group(mesh))


def active_tp_group():
    """The tp group of the `tp_scope` the caller is in (None outside one):
    gradient-checkpoint recomputation re-enters it (`models/unet.py`)."""
    return _TP_GROUP.get()


def site_tp_group(cut: Optional[TPCut]):
    """The group a site cut as `cut` reduces over (None for a whole site).
    A cut site raises outside `tp_scope` of the mesh it was cut for: a rank
    alone holds a part of its weights."""
    if cut is None:
        return None
    active = _TP_GROUP.get()
    if active is not cut.group:
        where = "with no tp mesh" if active is None else "over another tp group"
        raise RuntimeError(f"a UNet cut over tp ({cut.size} ranks) runs {where}: call "
                           "DADD.sample(mesh=) or the train step with the mesh it was cut for")
    return cut.group


def tp_all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Every tp rank's `t` reduced by `op` (the sum by default), in place,
    in t's dtype (a collective over the tp group). Every tp collective of
    the model goes through it (g, f's backward, the int8 row-parallel
    scales and accumulators)."""
    dist.all_reduce(t, op=op, group=group)
    return t


# Megatron's pair (Shoeybi et al. 2019, §3): f at a column-parallel site's
# replicated input, g at a row-parallel site's output. Not
# torch.distributed.nn.functional.all_reduce, whose backward all-reduces
# again: the replicated stream's gradient would come out tp times too large.
class _CopyToTP(torch.autograd.Function):
    """f: the identity forward; backward, the sum of every tp rank's
    gradient (each rank's columns contribute a part of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return tp_all_reduce(grad.clone(memory_format=torch.contiguous_format), ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    """g: the sum of every tp rank's partial product forward (in place);
    backward, the identity (every rank needs the whole gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.mark_dirty(x)
        return tp_all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """f over `group` (`x` itself where it is None)."""
    return x if group is None else _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """g over `group`: `x` summed over the tp ranks, in place (`x` itself
    where it is None; the plain all-reduce where no gradient is taken)."""
    if group is None:
        return x
    if not torch.is_grad_enabled():
        return tp_all_reduce(x, group)
    return _ReduceFromTP.apply(x, group)
