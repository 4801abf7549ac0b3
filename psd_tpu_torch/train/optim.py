"""Optimizer + LR schedule.

Counterpart of `psd_tpu/train/optim.py` (optax), which matches the reference:
  * AdamW, betas and weight decay from the config;
  * LinearWarmupCosineAnnealingLR, epoch-granular: linear warmup from
    lr·0.01 over `warmup_epochs`, cosine to `min_lr` at `training.max_epochs`,
    evaluated from the optimizer-step count;
  * two LR groups: the image projection and the purifier at 2× the base LR;
  * global-norm gradient clip (`training.gradient_clip_val`);
  * gradient accumulation as `optax.MultiSteps` does it: the running mean of
    k micro-gradients, one optimizer step every k; the clip applies to the
    averaged gradient, and the LR schedule counts optimizer steps.

The clip takes optax's formula, `g` below the threshold and `g / ‖g‖ · clip`
above it, not `torch.nn.utils.clip_grad_norm_` (which scales by
clip / (‖g‖ + 1e-6) at every norm): the reference and its tests use optax's.

The AdamW itself is `torch.optim.AdamW` (the same update as optax.adamw:
eps 1e-8 outside the square root, decoupled decay lr·wd·p), one parameter
group per LR group. Unlike optax the state is updated in place.

A step's work is split so that one captured CUDA graph serves every step
(`train/trainer.py::compile_train_step`, as psd_tpu's one jitted step takes
the LR and the counts as traced values): what changes from step to step is
a device tensor, filled on the host before the step, never a number baked
into the step. `set_lr` fills each group's LR, a 0-d fp32 tensor on the
parameters' device, from its schedule at the optimizer-step count;
`accumulation_scalars` gives the micro-step count n and n + 1 as 0-d fp32
tensors; `apply_` is the device work (the running mean, the clip, AdamW);
`advance` moves the host counts once the step has run. On the card AdamW is
`capturable=True` (its step counts on the device, no host read), in the
eager step as in its replay, so the two agree bit for bit; torch refuses
`capturable` on the CPU, which keeps the tensor LRs without it (and reads
the step count on the host there). `update` is the four in order.

Under FSDP2 (`train/trainer.py::shard_train_state`) the gradients, moments
and accumulators are DTensors sharded over the fsdp ranks, and under tp the
cut parameters' are each tp rank's slice: the global norm (`GradGroups`)
sums the cut tensors' squares over the tp group, adds the others' once
(every tp rank holds them whole), then sums over the fsdp shards, so it is
the whole gradient tree's norm, optax's `global_norm`; the clip and the
accumulation act on the local shards (`parallel.mesh.local`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core.config import Config
from ..parallel.mesh import local

DOUBLE_LR_MODULES = ("image_projection", "feature_purifier")


def warmup_cosine_epochwise(base_lr: float, warmup_epochs: int, max_epochs: int,
                            steps_per_epoch: int, min_lr: float = 1e-6,
                            warmup_start_factor: float = 0.01) -> Callable[[int], float]:
    """Epoch-granular warmup → cosine, evaluated from the global step."""
    warmup_start = base_lr * warmup_start_factor

    def schedule(step: int) -> float:
        epoch = min(step // max(steps_per_epoch, 1), max_epochs)
        if epoch < warmup_epochs:
            frac = min(max(epoch / max(warmup_epochs, 1), 0.0), 1.0)
            return warmup_start + (base_lr - warmup_start) * frac
        t = min(max((epoch - warmup_epochs) / max(max_epochs - warmup_epochs, 1), 0.0), 1.0)
        return min_lr + 0.5 * (base_lr - min_lr) * (1 + math.cos(math.pi * t))

    return schedule


def group_label(name: str) -> str:
    """2× LR for the image projection and the purifier, 1× for the rest
    (psd_tpu/train/optim.py:47-52); `name` is a dotted parameter name."""
    return "x2" if any(p in DOUBLE_LR_MODULES for p in name.split(".")) else "x1"


@dataclass(frozen=True)
class GradGroups:
    """Where a list of tensors' squares are summed across ranks: `shard`,
    the group over which each tensor is a shard (FSDP2's fsdp group);
    `tp`, the tp group, over which the tensors flagged in `cut` are slices
    (the others whole on every tp rank)."""
    shard: object = None
    tp: object = None
    cut: Tuple[bool, ...] = ()


def global_norm(tensors: Sequence[torch.Tensor],
                groups: Optional[GradGroups] = None) -> torch.Tensor:
    """sqrt(Σ‖t‖²) over a list of tensors, as a 0-d fp32 tensor; with
    `groups`, of the whole tensors whose shards and slices these are."""
    norms = torch.stack(torch._foreach_norm([local(t) for t in tensors])).float()
    if groups is None:
        return torch.linalg.vector_norm(norms)
    sq = norms.square()
    if groups.tp is not None:
        cut = torch.tensor(groups.cut, dtype=torch.bool, device=sq.device)
        part = sq[cut].sum()
        dist.all_reduce(part, group=groups.tp)
        total = sq[~cut].sum() + part
    else:
        total = sq.sum()
    if groups.shard is not None:
        dist.all_reduce(total, group=groups.shard)
    return total.sqrt()


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         groups: Optional[GradGroups] = None) -> torch.Tensor:
    """optax.clip_by_global_norm in place: unchanged below `max_norm`,
    g / ‖g‖ · max_norm above it. Returns the norm before clipping."""
    norm = global_norm(grads, groups)
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_([local(g) for g in grads], factor)
    return norm


@dataclass
class OptState:
    adamw: torch.optim.AdamW
    count: int = 0       # optimizer steps applied (optax's inner count)
    mini_step: int = 0   # micro-steps into the current accumulation
    acc: Optional[List[torch.Tensor]] = field(default=None, repr=False)


class Optimizer:
    """chain(clip_by_global_norm, multi_transform({x1, x2}: adamw)), inside
    MultiSteps when accumulating; `init` binds it to a module's parameters."""

    def __init__(self, schedules: Dict[str, Callable[[int], float]], betas, weight_decay: float,
                 clip: float = 0.0, accumulate: int = 1):
        self.schedules = schedules
        self.betas = tuple(betas)
        self.weight_decay = weight_decay
        self.clip = clip
        self.accumulate = max(int(accumulate or 1), 1)

    def init(self, module: torch.nn.Module) -> OptState:
        groups: Dict[str, list] = {"x1": [], "x2": []}
        for name, p in module.named_parameters():
            groups[group_label(name)].append(p)
        dev = next(module.parameters()).device
        # on the card capturable (step counts on the device, the tensor LRs
        # read there) and foreach; on the CPU, where torch refuses
        # capturable, the per-tensor loop, which takes a tensor LR without it
        on_card = dev.type == "cuda"
        adamw = torch.optim.AdamW(
            [{"params": ps, "label": lab,
              "lr": torch.full((), self.schedules[lab](0), dtype=torch.float32, device=dev)}
             for lab, ps in groups.items() if ps],
            betas=self.betas, eps=1e-8, weight_decay=self.weight_decay,
            capturable=on_card, foreach=on_card)
        return OptState(adamw)

    def applies(self, state: OptState) -> bool:
        """True when the next step applies an optimizer step (always, unless
        accumulating: then at the last of `accumulate` micro-steps)."""
        return state.mini_step + 1 >= self.accumulate

    @torch.no_grad()
    def set_lr(self, state: OptState) -> None:
        """Fill each group's LR tensor from its schedule at the optimizer-step
        count (a fill on the device: no copy from the host, no wait)."""
        for group_ in state.adamw.param_groups:
            group_["lr"].fill_(self.schedules[group_["label"]](state.count))

    def accumulation_scalars(self, state: OptState, device) -> Tuple[torch.Tensor, ...]:
        """(n, n + 1) as 0-d fp32 tensors on `device`, n the micro-steps
        accumulated so far; () without accumulation."""
        if self.accumulate == 1:
            return ()
        n = state.mini_step
        return tuple(torch.full((), float(v), dtype=torch.float32, device=device)
                     for v in (n, n + 1))

    @torch.no_grad()
    def apply_(self, state: OptState, params: Sequence[torch.nn.Parameter],
               grads: List[torch.Tensor], groups: Optional[GradGroups], applies: bool,
               scalars: Tuple[torch.Tensor, ...] = ()) -> None:
        """The step's device work: fold `grads` (one per parameter, shards
        and slices over `groups` if given) into the running mean with
        `scalars` = (n, n + 1) when accumulating; where `applies`, the clip
        and AdamW at the LRs `set_lr` filled in. Reads no host value."""
        if self.accumulate > 1:
            if state.acc is None:
                state.acc = [torch.zeros_like(g) for g in grads]
            acc, g_local = [local(a) for a in state.acc], [local(g) for g in grads]
            n, n1 = scalars
            torch._foreach_mul_(acc, n)
            torch._foreach_add_(acc, g_local)
            torch._foreach_div_(acc, n1)
            if not applies:
                return
            torch._foreach_copy_(g_local, acc)  # the mean, in the gradients' place
            torch._foreach_zero_(acc)
        if self.clip and self.clip > 0:
            clip_by_global_norm_(grads, self.clip, groups)
        for p, g in zip(params, grads):
            p.grad = g
        state.adamw.step()

    def advance(self, state: OptState, applies: bool) -> None:
        """The host counts after a step has run (`applies` as `applies()`
        said before it)."""
        if self.accumulate > 1:
            state.mini_step = 0 if applies else state.mini_step + 1
        if applies:
            state.count += 1

    def update(self, state: OptState, params: Sequence[torch.nn.Parameter],
               grads: List[torch.Tensor], groups: Optional[GradGroups] = None) -> bool:
        """Fold `grads` in, op by op; True when an optimizer step was
        applied (always, unless accumulating). psd_tpu's `tx.update`, for
        callers stepping by hand: the train step calls the four parts itself."""
        applies = self.applies(state)
        if applies:
            self.set_lr(state)
        self.apply_(state, params, grads, groups, applies,
                    self.accumulation_scalars(state, grads[0].device))
        self.advance(state, applies)
        return applies


def build_optimizer(cfg: Config, steps_per_epoch: int = 1000) -> Optimizer:
    """`steps_per_epoch` counts optimizer steps (batches // accumulation)."""
    opt, sch = cfg.optimizer, cfg.scheduler

    def schedule(lr):
        return warmup_cosine_epochwise(lr, sch.warmup_epochs, cfg.training.max_epochs,
                                       steps_per_epoch, min_lr=sch.min_lr)

    return Optimizer({"x1": schedule(opt.lr), "x2": schedule(opt.lr * 2)}, opt.betas,
                     opt.weight_decay, clip=cfg.training.gradient_clip_val,
                     accumulate=getattr(cfg.training, "accumulate_grad_batches", 1))
