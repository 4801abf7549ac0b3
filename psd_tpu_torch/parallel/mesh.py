"""Data parallelism over torch.distributed: one process per card.

Counterpart of `psd_tpu/parallel/mesh.py`. psd_tpu is one controller over a
`Mesh(dp, fsdp, tp)`: the batch's dim 0 is split over ("dp", "fsdp"), the
state is fsdp-sharded on each parameter's largest divisible dim, XLA
all-reduces the gradients and each Pallas kernel `shard_map`s itself over
the batch axes. The port runs one process per rank, started by `torchrun`:
the process is the shard, so each rank runs the unchanged kernels on its own
rows, and `shard_map_batch0`, `kernel_batch_axes` and `constrain_batch` have
no counterpart. The mesh is a `DeviceMesh` of shape (dp, fsdp); the train
state goes under DDP (fsdp = 1) or FSDP2 (fsdp > 1, HSDP over the 2-D mesh;
`train/trainer.py::shard_train_state`).

  * A rank's rows: rank = dp_index · fsdp + fsdp_index owns the rank-th
    contiguous block of dim 0, as `P(("dp", "fsdp"))` lays the rows out.
  * `fsdp_shard_dim` is `fsdp_param_spec`'s rule (the largest dim that
    divides and holds at least two rows a rank); where no dim qualifies
    psd_tpu replicates the parameter, and FSDP2, which shards every
    parameter, takes its default Shard(0), padded.
  * tp is not ported (ROADMAP.md Queue 1 item 7): tp ≠ 1 raises.

A DTensor's values are read and written through `local` (its shard; a plain
tensor is its own), `local_part` cuts a full tensor to another's shard, and
`full` gathers a shard back (a collective: every rank calls it).

Sampling and serving (`DADD.sample(mesh=)`, `GenerationServer(mesh=)`)
split the batch as psd_tpu's `batch_sharding` does and replicate the
model: each rank runs its rows (`batch_rows`), `gather_rows` puts the
ranks' rows back together into the global batch on every rank, and
`broadcast` hands rank 0's tensors to the others.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist
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
        """psd_tpu's rule, with every rank placed: dp · fsdp must be the
        world size (a rank with no place in the mesh has nothing to do)."""
        if self.tp != 1:
            raise NotImplementedError(
                f"tp={self.tp}: tensor parallelism is not ported (ROADMAP.md Queue 1 item 7)")
        if self.fsdp < 1 or self.dp == 0 or self.dp < -1:
            raise ValueError(f"mesh dp={self.dp} fsdp={self.fsdp}: dp is -1 or ≥ 1, fsdp ≥ 1")
        dp = world_size // self.fsdp if self.dp == -1 else self.dp
        if dp < 1 or dp * self.fsdp != world_size:
            need = max(dp, 1) * self.fsdp
            raise ValueError(
                f"mesh dp={self.dp} fsdp={self.fsdp} needs {need} ranks, the world has "
                f"{world_size}: start one process per rank, e.g. `torchrun --nproc-per-node "
                f"{need} -m psd_tpu_torch.pipelines.train ...`")
        return MeshConfig(dp=dp, fsdp=self.fsdp)


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
    """The (dp, fsdp) DeviceMesh over the process group, which is started
    from torchrun's environment (NCCL on cuda, gloo on cpu) unless the
    caller started one."""
    if device_type == "cuda":
        # before the group and the mesh, which would take LOCAL_RANK itself
        torch.cuda.set_device(rank_device("cuda"))
        torch.cuda.init()
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                timeout=timedelta(seconds=TIMEOUT_S))
    cfg = (cfg or MeshConfig()).resolve(dist.get_world_size())
    return init_device_mesh(device_type, (cfg.dp, cfg.fsdp), mesh_dim_names=("dp", "fsdp"))


def shard_rows(n: int, dp: int, fsdp: int, dp_index: int, fsdp_index: int) -> slice:
    """The rows of dim 0 that mesh position (dp_index, fsdp_index) holds."""
    shards = dp * fsdp
    if n % shards:
        raise ValueError(f"a batch of {n} rows does not split over {dp} × {fsdp} ranks")
    k, i = n // shards, dp_index * fsdp + fsdp_index
    return slice(i * k, (i + 1) * k)


def batch_rows(mesh: Optional[DeviceMesh], n: int) -> slice:
    """This rank's rows of a global batch of n; all of them without a mesh."""
    if mesh is None:
        return slice(0, n)
    dp_index, fsdp_index = mesh.get_coordinate()
    return shard_rows(n, mesh["dp"].size(), mesh["fsdp"].size(), dp_index, fsdp_index)


def mesh_group(mesh: DeviceMesh):
    """The process group over every rank of `mesh`: the world, whose rank
    order is the order of `batch_rows`' blocks where the mesh lays the
    world out as `create_mesh` does (rank = dp_index · fsdp + fsdp_index)."""
    ranks = mesh.mesh.flatten().tolist()
    if ranks != list(range(dist.get_world_size())):
        raise ValueError(f"a mesh over ranks {ranks} is not the world in rank order "
                         "(build it with create_mesh)")
    return dist.group.WORLD


def gather_rows(mesh: Optional[DeviceMesh], part: torch.Tensor) -> torch.Tensor:
    """The global batch on every rank from each rank's rows of it
    (`batch_rows`' blocks of dim 0, every rank the same count): c10d's
    all_gather_into_tensor over every rank of the mesh (a collective: every
    rank calls it); `part` itself without a mesh."""
    if mesh is None:
        return part
    part = part.contiguous()
    whole = part.new_empty((mesh.size() * part.shape[0],) + tuple(part.shape[1:]))
    dist.all_gather_into_tensor(whole, part, group=mesh_group(mesh))
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
