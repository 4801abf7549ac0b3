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
group per LR group; `update` sets each group's LR from its schedule before
every step. Unlike optax the state is updated in place.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..core.config import Config

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


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ‖t‖²) over a list of tensors, as a 0-d fp32 tensor."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))).float())


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: unchanged below `max_norm`,
    g / ‖g‖ · max_norm above it. Returns the norm before clipping."""
    norm = global_norm(grads)
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, factor)
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
        adamw = torch.optim.AdamW(
            [{"params": ps, "label": lab, "lr": self.schedules[lab](0)}
             for lab, ps in groups.items() if ps],
            betas=self.betas, eps=1e-8, weight_decay=self.weight_decay)
        return OptState(adamw)

    def update(self, state: OptState, params: Sequence[torch.nn.Parameter],
               grads: List[torch.Tensor]) -> bool:
        """Fold `grads` (one per parameter) in; True when an optimizer step
        was applied (always, unless accumulating)."""
        if self.accumulate > 1:
            if state.acc is None:
                state.acc = [torch.zeros_like(g) for g in grads]
            n = state.mini_step
            torch._foreach_mul_(state.acc, float(n))
            torch._foreach_add_(state.acc, grads)
            torch._foreach_div_(state.acc, float(n + 1))
            if n + 1 < self.accumulate:
                state.mini_step = n + 1
                return False
            state.mini_step = 0
            grads = [a.clone() for a in state.acc]
            torch._foreach_zero_(state.acc)
        if self.clip and self.clip > 0:
            clip_by_global_norm_(grads, self.clip)
        for p, g in zip(params, grads):
            p.grad = g
        for group in state.adamw.param_groups:
            group["lr"] = self.schedules[group["label"]](state.count)
        state.adamw.step()
        state.count += 1
        return True


def build_optimizer(cfg: Config, steps_per_epoch: int = 1000) -> Optimizer:
    """`steps_per_epoch` counts optimizer steps (batches // accumulation)."""
    opt, sch = cfg.optimizer, cfg.scheduler

    def schedule(lr):
        return warmup_cosine_epochwise(lr, sch.warmup_epochs, cfg.training.max_epochs,
                                       steps_per_epoch, min_lr=sch.min_lr)

    return Optimizer({"x1": schedule(opt.lr), "x2": schedule(opt.lr * 2)}, opt.betas,
                     opt.weight_decay, clip=cfg.training.gradient_clip_val,
                     accumulate=getattr(cfg.training, "accumulate_grad_batches", 1))
