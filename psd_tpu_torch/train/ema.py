"""EMA of the trainable parameters.

Counterpart of `psd_tpu/train/ema.py` (the reference's EMAWeightAveraging
callback): decay 0.999; updates start at `update_starting_at_step` and
happen every `update_every_n_steps`; the first update copies the parameters
(torch AveragedModel with n_averaged == 0). The port updates the average in
place (JAX's is a pure function returning a new tree). `swapped_in` puts
the average in the module's place for validation and back (the reference's
EMA swap; psd_tpu passes the EMA tree to its jitted functions).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Iterator, Mapping

import torch
from torch import nn


@dataclass
class EMAState:
    params: Dict[str, torch.Tensor]
    count: int = 0  # EMA updates applied (0 → not initialised yet)


@torch.no_grad()
def ema_init(params: Mapping[str, torch.Tensor]) -> EMAState:
    """A copy of `params` (name → tensor)."""
    return EMAState({k: v.detach().clone() for k, v in params.items()})


@torch.no_grad()
def ema_update(state: EMAState, params: Mapping[str, torch.Tensor], step: int,
               decay: float = 0.999, start_step: int = 100, every: int = 4) -> EMAState:
    """Fold `params` into the average at this step, when the gating says so."""
    if not (step >= start_step and (step - start_step) % every == 0):
        return state
    avg = list(state.params.values())
    new = [params[k].detach() for k in state.params]
    if state.count == 0:
        torch._foreach_copy_(avg, new)
    else:
        torch._foreach_mul_(avg, decay)
        torch._foreach_add_(avg, new, alpha=1.0 - decay)
    state.count += 1
    return state


@contextlib.contextmanager
def swapped_in(module: nn.Module, state: EMAState) -> Iterator[None]:
    """The EMA's tensors in place of `module`'s parameters inside the block,
    the parameters back after it. No copies: the storages are exchanged."""
    params = dict(module.named_parameters())

    def swap():
        with torch.no_grad():
            for name in state.params:
                params[name].data, state.params[name] = state.params[name], params[name].data

    swap()
    try:
        yield
    finally:
        swap()
