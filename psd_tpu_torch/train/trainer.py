"""Train state and the train step, on one device.

Counterpart of `psd_tpu/train/trainer.py` (`TrainState`,
`create_train_state`, `make_train_step`) without the mesh: one card, no
data parallelism (torch.distributed waits). One step is `DADD.train_loss`
in training mode (`core.mode.training_mode()`, entered here as psd_tpu's
step enters it, so a validation loss outside a step keeps the serving
kernels) → backward → gradient norm → clip + AdamW (+ gradient
accumulation) → EMA, exactly the JAX step's order. The state is updated in
place and returned.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ..core.mode import training_mode
from ..diffusion.dadd import DADD
from .ema import EMAState, ema_init, ema_update
from .optim import Optimizer, OptState, build_optimizer, global_norm


@dataclass
class TrainState:
    step: int
    model: DADD
    opt_state: OptState
    ema: EMAState
    generator: torch.Generator


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


def make_train_step(dadd: DADD, tx: Optimizer):
    tcfg = dadd.cfg.training
    named = dict(dadd.core.named_parameters())
    params = list(named.values())

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   draws: Optional[Dict[str, torch.Tensor]] = None):
        """One step on `batch` (pre-encoded latents, labels, clip_feats);
        `draws` overrides the generator's random numbers (tests)."""
        for p in params:
            p.grad = None
        with training_mode():
            loss, metrics = dadd.train_loss(batch, generator=state.generator, draws=draws)
            loss.backward()
        # a parameter the loss does not reach gets a zero gradient, as under
        # jax.grad (AdamW then still applies its weight decay)
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        metrics["grad_norm"] = global_norm(grads)
        applied = tx.update(state.opt_state, params, grads)
        if tx.accumulate > 1:
            # EMA start/every count optimizer steps; micro-steps never update
            ema_step = state.opt_state.count - 1 if applied else -1
        else:
            ema_step = state.step
        ema_update(state.ema, named, ema_step, decay=tcfg.ema_decay,
                   start_step=tcfg.update_starting_at_step, every=tcfg.update_every_n_steps)
        state.step += 1
        return state, metrics

    return train_step
