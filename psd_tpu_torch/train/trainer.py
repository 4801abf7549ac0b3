"""Train state and the train step, on one card or one rank of many.

Counterpart of `psd_tpu/train/trainer.py` (`TrainState`,
`create_train_state`, `make_train_step`, `shard_train_state`). One step is
`DADD.train_loss` in training mode (`core.mode.training_mode()`, entered
here as psd_tpu's step enters it, so a validation loss outside a step keeps
the serving kernels) → backward → gradient norm → clip + AdamW (+ gradient
accumulation) → EMA, exactly the JAX step's order. The state is updated in
place and returned.

Across ranks (`parallel/mesh.py`, one process per card under torchrun)
`shard_train_state` puts the loss (`diffusion.dadd.TrainLoss`) under DDP
when fsdp = 1, which averages the core's gradients over the dp ranks, or
under FSDP2 `fully_shard` on the (dp, fsdp) mesh when fsdp > 1 (HSDP:
replicated over dp, sharded over fsdp; each ResnetBlock2D and Transformer2D
of the UNet first, then the loss as the root), and shards the AdamW moments
and the EMA as their parameters. On a (dp, fsdp, tp) mesh the UNet's
transformer sites are cut over tp first (`DADD.shard_tp_`, as psd_tpu's
`param_spec` puts tp first), with the moments, the accumulated gradients
and the EMA cut alike; DDP then runs over the dp group, FSDP2 on the
(dp, fsdp) sub-mesh, each tp rank's slices with the other ranks of its tp
index. FSDP2 also shards the cut slices over fsdp, where psd_tpu keeps a
tp-cut parameter whole over fsdp: the same math, as where FSDP2 shards
what psd_tpu replicates. The step runs inside the mesh's tp scope: the
cut sites' f and g (`parallel/mesh.py`) make each replicated parameter's
gradient whole on every tp rank. No `MixedPrecisionPolicy`: the fp32
masters are cast to bf16 at use, as on one card. Each rank feeds the step
its own rows of the global batch (`parallel.mesh.shard_batch`) and draws
the global batch's draws from the generator every rank seeds alike, then
takes its rows (`shard_draws`): the local mean loss's averaged gradient is
the gradient of the global mean, and the step is the one-card step on the
global batch up to the order of the reductions, as psd_tpu's sharded step
is. The logged metrics are averaged over the ranks.

`compile_train_step` is psd_tpu's `compile_train_step` (a `jax.jit` of the
step with the state donated): on the card, with no mesh, a step is one
replay of a CUDA graph (`diffusion/graphs.py`) that holds the loss forward,
the backward (with the gradient checkpointing's recomputation), the global
norm, the clip, AdamW in its two LR groups and the EMA. Everything that
changes from step to step is a device input, so one program serves every
step: the batch and the draws (drawn from `state.generator` outside the
graph, in `sample_draws`' order, and copied into the program's inputs, as
generate takes its x0), the LRs (`Optimizer.set_lr`), the EMA's gate
(`ema.ema_flags`) and, when accumulating, the micro-step count. The host
counts (`state.step`, the optimizer's count and micro-step, the EMA's
count) advance once a step has run, never at a capture. The first call of
a program's key is its warm-up: an eager step on a side stream, which is
that call's step; the capture after it records without running. When
accumulating, the micro-step and the applying step are two programs on one
graph pool. The programs and their pool belong to the train state they
write (`TrainState.programs`), so a new state on the same model captures
its own and a dropped state's go with it. On the CPU, under
`core.mode.eager()` and with a mesh (gloo's collectives cannot be
captured, and NCCL takes no two ranks on one card) the same body runs op
by op, as `make_train_step` runs it always. A failed warm-up, capture or
replay raises; no path gives way to another.
"""

from __future__ import annotations

import contextlib
import gc
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..core.mode import training_mode
from ..diffusion.dadd import DADD, TrainLoss, shard_draws
from ..diffusion.graphs import CapturedProgram
from ..parallel.mesh import (batch_rows, local_part, shard_group, shard_placement, tp_cuts,
                             tp_scope, tp_size, tp_slice)
from .ema import EMAState, ema_apply_, ema_flags, ema_gate, ema_init
from .optim import GradGroups, Optimizer, OptState, build_optimizer, global_norm


@dataclass
class TrainState:
    step: int
    model: DADD
    opt_state: OptState
    ema: EMAState
    generator: torch.Generator
    # across ranks (shard_train_state): the loss under DDP or FSDP2
    loss: Optional[nn.Module] = None
    # compile_train_step's captured programs by key, and the graph pool they
    # share: the state's own, since a program writes the tensors of the
    # state it was captured for (its moments, EMA and LRs), and they go
    # with the state
    programs: Dict[tuple, CapturedProgram] = field(default_factory=dict, repr=False)
    pool: Optional[tuple] = field(default=None, repr=False)

    def drop_programs(self) -> None:
        """Free the state's captured programs and their pool; the next step
        captures again."""
        self.programs.clear()
        self.pool = None
        gc.collect()
        if self.model.device.type == "cuda":
            torch.cuda.empty_cache()


def create_train_state(dadd: DADD, tx: Optional[Optimizer] = None, steps_per_epoch: int = 1000,
                       seed: Optional[int] = None) -> Tuple[TrainState, Optimizer]:
    """Bind the optimizer and the EMA to `dadd`'s core (already initialised:
    `DADD(..., for_training=True)` seeds it, `load_flax` replaces it). The
    draws of every step come from a generator on the model's device, seeded
    from `training.seed` unless `seed` is given."""
    if not dadd.for_training:
        raise ValueError("training needs fp32 master weights: DADD(..., for_training=True)")
    tx = tx or build_optimizer(dadd.cfg, steps_per_epoch)
    gen = torch.Generator(device=dadd.device)
    gen.manual_seed(dadd.cfg.training.seed if seed is None else seed)
    state = TrainState(step=0, model=dadd, opt_state=tx.init(dadd.core),
                       ema=ema_init(dict(dadd.core.named_parameters())), generator=gen)
    return state, tx


def _unet_blocks(dadd: DADD):
    from ..models.unet import ResnetBlock2D, Transformer2D

    return [m for m in dadd.core.unet.children() if isinstance(m, (ResnetBlock2D, Transformer2D))]


@torch.no_grad()
def _cut_state_tp_(state: TrainState, mesh) -> None:
    """Cut the UNet over the mesh's tp axis, and each cut parameter's
    moments, accumulated gradient and EMA to the same slice (a state that
    has taken steps; net_0_proj's packed halves alike)."""
    dadd, opt = state.model, state.opt_state
    dadd.shard_tp_(mesh)
    named = dict(dadd.core.named_parameters())
    cuts = tp_cuts(dadd.core)

    def cut(name, t):
        dim, halves, c = cuts[name]
        return tp_slice(t, dim, halves, c.size, c.rank)

    for name in cuts:
        s = opt.adamw.state.get(named[name])
        if s:
            s["exp_avg"], s["exp_avg_sq"] = cut(name, s["exp_avg"]), cut(name, s["exp_avg_sq"])
        state.ema.params[name] = cut(name, state.ema.params[name])
    if opt.acc is not None:
        opt.acc = [cut(k, a) if k in cuts else a for k, a in zip(named, opt.acc)]


@torch.no_grad()
def shard_train_state(state: TrainState, mesh) -> TrainState:
    """Place the state on the mesh (psd_tpu's `shard_train_state`): the UNet
    cut over tp where the mesh has a tp axis, then the loss under DDP over
    the dp group (fsdp = 1) or FSDP2 on the (dp, fsdp) sub-mesh (fsdp > 1),
    the moments, the accumulated gradients and the EMA as their parameters.
    The state may have taken steps: its full tensors are cut to each rank's
    slices and shards."""
    from torch.distributed.fsdp import fully_shard
    from torch.nn.parallel import DistributedDataParallel as DDP

    dadd, opt = state.model, state.opt_state
    tp = tp_size(mesh)
    if tp > 1:
        _cut_state_tp_(state, mesh)
    old = dict(dadd.core.named_parameters())
    loss = TrainLoss(dadd)
    n = mesh["fsdp"].size()
    if n > 1:
        place = shard_placement(n)
        data_mesh = mesh if tp == 1 else mesh["dp", "fsdp"]
        for block in _unet_blocks(dadd):
            fully_shard(block, mesh=data_mesh, shard_placement_fn=place)
        state.loss = fully_shard(loss, mesh=data_mesh, shard_placement_fn=place)
    else:
        # static_graph: the parameters the loss never reaches (whose
        # gradients stay None, zeros below) are found at the first step
        state.loss = DDP(loss, device_ids=None if dadd.device.type == "cpu" else [dadd.device],
                         process_group=mesh.get_group("dp"), static_graph=True)
    new = dict(dadd.core.named_parameters())
    if any(new[k] is not old[k] for k in old):
        moments = {k: opt.adamw.state.get(p) for k, p in old.items()}
        name = {id(p): k for k, p in old.items()}
        groups = [dict(g, params=[new[name[id(p)]] for p in g["params"]])
                  for g in opt.adamw.param_groups]
        opt.adamw = torch.optim.AdamW(groups, **{k: opt.adamw.defaults[k] for k in
                                                 ("betas", "eps", "weight_decay", "capturable",
                                                  "foreach")})
        for k, s in moments.items():
            if s:
                opt.adamw.state[new[k]] = {
                    "step": s["step"], "exp_avg": local_part(s["exp_avg"], new[k]),
                    "exp_avg_sq": local_part(s["exp_avg_sq"], new[k])}
        if opt.acc is not None:
            opt.acc = [local_part(a, new[k]) for a, k in zip(opt.acc, old)]
        state.ema.params = {k: local_part(t, new[k]) for k, t in state.ema.params.items()}
    return state


def is_sharded(state: TrainState) -> bool:
    """True where the state is under FSDP2 (its tensors are shards)."""
    from torch.distributed.fsdp import FSDPModule

    return isinstance(state.loss, FSDPModule)


@contextlib.contextmanager
def full_parameters(state: TrainState) -> Iterator[None]:
    """The core's parameters whole inside the block, on every rank, for
    what runs outside the step (validation, the embedder's statistics):
    under FSDP2 the root's group is gathered (each UNet block gathers its
    own in its forward); nothing to do on one card or under DDP. Every
    rank enters it together."""
    if not is_sharded(state):
        yield
        return
    state.loss.unshard()
    try:
        yield
    finally:
        state.loss.reshard()


def _mean_over_ranks(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each metric (a mean over this rank's rows) averaged over the ranks:
    the global batch's mean, the ranks' row counts being equal."""
    keys = sorted(metrics)
    stacked = torch.stack([metrics[k].detach().float() for k in keys])
    dist.all_reduce(stacked)
    stacked /= dist.get_world_size()
    return dict(zip(keys, stacked.unbind()))


def _grad_groups(named: Dict[str, torch.Tensor], cuts: dict) -> GradGroups:
    """Where the gradients' squares are summed (optax's global norm of the
    whole tree): FSDP2's fsdp group, the tp group over the cut
    parameters."""
    tp = next(iter(cuts.values()))[2].group if cuts else None
    return GradGroups(shard=shard_group(next(iter(named.values()))), tp=tp,
                      cut=tuple(k in cuts for k in named))


def make_train_step(dadd: DADD, tx: Optimizer, mesh=None):
    """The step, op by op. With a `mesh` (after `shard_train_state`) the
    batch holds this rank's rows (the same on the tp ranks of a (dp, fsdp)
    position) and the draws, when given, are the global batch's."""
    return TrainStep(dadd, tx, mesh, capture=False)


def compile_train_step(dadd: DADD, tx: Optimizer, mesh=None):
    """The step as `make_train_step` takes it and returns its results; on
    the card with no mesh, outside `core.mode.eager()`, one replay of a
    captured program a step (psd_tpu's `compile_train_step`)."""
    return TrainStep(dadd, tx, mesh, capture=True)


class TrainStep:
    """`step(state, batch, draws=None) -> (state, metrics)`: one step on
    `batch` (pre-encoded latents, labels, clip_feats); `draws` overrides
    the generator's random numbers (tests, the CLI). The host part (the
    draws, the LRs, the EMA's gate, the counts) runs here; `_body` is the
    device part, run op by op or replayed. With `capture` its programs live
    in the state's `programs`, on the state's `pool`, under the kind
    "train_step", keyed by the inputs' names and shapes, whether the step
    applies the optimizer and the mode flags."""

    def __init__(self, dadd: DADD, tx: Optimizer, mesh, capture: bool):
        self.dadd, self.tx, self.mesh, self.capture = dadd, tx, mesh, capture

    def __call__(self, state: TrainState, batch: Dict[str, torch.Tensor],
                 draws: Optional[Dict[str, torch.Tensor]] = None):
        dadd, tx, mesh, tcfg = self.dadd, self.tx, self.mesh, self.dadd.cfg.training
        opt = state.opt_state
        if state.ema.swapped:
            raise RuntimeError("train step inside ema.swapped_in: the EMA's tensors are the "
                               "module's parameters there")
        batch = {k: dadd._t(v) for k, v in batch.items() if v is not None}
        if mesh is not None:
            n_local = len(batch["labels"])
            n = n_local * mesh.size(0) * mesh.size(1)  # the (dp, fsdp) positions' rows
            if draws is None:
                shape = (n,) + tuple(batch["latents"].shape[1:])
                draws = dadd.sample_draws(shape, state.generator)
            draws = shard_draws(draws, batch_rows(mesh, n))
        elif draws is None:
            draws = dadd.sample_draws(tuple(batch["latents"].shape), state.generator)
        draws = {k: v.to(dadd.device) for k, v in draws.items()}
        # the host's decisions, then the device inputs that carry them
        applies = tx.applies(opt)
        do_ema = applies and ema_gate(state.step if tx.accumulate == 1 else opt.count,
                                      tcfg.update_starting_at_step, tcfg.update_every_n_steps)
        if applies:
            tx.set_lr(opt)
        scalars = ema_flags(state.ema, do_ema, dadd.device) + tx.accumulation_scalars(
            opt, dadd.device)
        parts = {"batch": batch, "draws": draws}
        names = tuple((part, k) for part in parts for k in sorted(parts[part]))
        inputs = tuple(parts[part][k] for part, k in names) + scalars

        def body(*flat):
            got = {"batch": {}, "draws": {}}
            for (part, k), t in zip(names, flat):
                got[part][k] = t
            return self._body(state, got["batch"], got["draws"], applies, flat[len(names):])

        if not self.capture or mesh is not None:
            metrics = body(*inputs)
        else:
            if state.pool is None and dadd.captures():
                state.pool = torch.cuda.graph_pool_handle()
            metrics = dadd._replay_or_run("train_step", body, inputs, stateful=True,
                                          pool=state.pool, programs=state.programs,
                                          names=names, applies=applies)
        tx.advance(opt, applies)
        state.ema.count += int(do_ema)
        state.step += 1
        return state, metrics

    def _body(self, state: TrainState, batch, draws, applies: bool, scalars):
        """The step's device work: loss, backward, norm, the optimizer's
        `apply_`, and the EMA where the step applies the optimizer; the
        scalars are (EMA do, EMA first[, n, n + 1]). Reads no host value and
        moves no host count."""
        dadd, tx, mesh = self.dadd, self.tx, self.mesh
        named = dict(dadd.core.named_parameters())
        params = list(named.values())
        for p in params:
            p.grad = None
        with training_mode(), tp_scope(mesh):
            if mesh is None:
                loss, metrics = dadd.train_loss(batch, draws=draws)
            else:
                loss, metrics = state.loss(batch, draws)
            loss.backward()
        if mesh is not None:
            metrics = _mean_over_ranks(metrics)
        # a parameter the loss does not reach gets a zero gradient, as under
        # jax.grad (AdamW then still applies its weight decay)
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        groups = None if mesh is None else _grad_groups(named, tp_cuts(dadd.core))
        metrics["grad_norm"] = global_norm(grads, groups)
        do, first, *acc = scalars
        tx.apply_(state.opt_state, params, grads, groups, applies, tuple(acc))
        if applies:
            # EMA start/every count optimizer steps; micro-steps never update
            ema_apply_(state.ema, named, do, first, decay=dadd.cfg.training.ema_decay)
        return metrics
