"""EMA of the trainable parameters.

Counterpart of `psd_tpu/train/ema.py` (the reference's EMAWeightAveraging
callback): decay 0.999; updates start at `update_starting_at_step` and
happen every `update_every_n_steps`; the first update copies the parameters
(torch AveragedModel with n_averaged == 0). The port updates the average in
place (JAX's is a pure function returning a new tree). `swapped_in` puts
the average in the module's place for validation and back (the reference's
EMA swap; psd_tpu passes the EMA tree to its jitted functions). Under FSDP2
the average is sharded as its parameters are and updated shard by shard.

The update is psd_tpu's select form, with the gate as two device flags, so
that one captured train step serves a step that skips the EMA, the first
copy and a blend (`train/trainer.py::compile_train_step`): `ema_gate` and
the count stay on the host, which fills `do` and `first` before the step,
and `ema_apply_` is the device work. It takes the select on the two
coefficients of avg·a + p·b, (a, b) = where(do, where(first, (0, 1),
(decay, 1 − decay)), (1, 0)): per element that is avg, p or psd_tpu's
decay·avg + (1 − decay)·p (two products and a sum, each rounded once), for
finite values, in three passes over the average instead of a select's
temporaries. A non-finite parameter at a step the gate skips makes the
average non-finite there (avg·1 + p·0), where psd_tpu's select keeps it
until its next update, which takes the non-finite value in too. Every step
reads the whole average, the steps the gate skips too, as psd_tpu's does
(`chip_smoke.py` phase 6 times a blend and a skipped step).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Iterator, Mapping, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from ..parallel.mesh import local


@dataclass
class EMAState:
    params: Dict[str, torch.Tensor]
    count: int = 0  # EMA updates applied (0 → not initialised yet)
    swapped: bool = False  # inside `swapped_in`: the average is the module's


# the parameters' entries an EMA pass takes at once: its products' temporaries
# stay under 512 MiB
EMA_CHUNK = 1 << 27


@torch.no_grad()
def ema_init(params: Mapping[str, torch.Tensor]) -> EMAState:
    """A copy of `params` (name → tensor)."""
    return EMAState({k: v.detach().clone() for k, v in params.items()})


def ema_gate(step: int, start_step: int, every: int) -> bool:
    """True when the EMA updates at this (0-based) step."""
    return step >= start_step and (step - start_step) % every == 0


def ema_flags(state: EMAState, do: bool, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(do, first) as 0-d bool tensors on `device`: the gate, and whether
    this update is the first (the copy)."""
    return tuple(torch.full((), v, dtype=torch.bool, device=device)
                 for v in (do, state.count == 0))


@torch.no_grad()
def ema_apply_(state: EMAState, params: Mapping[str, torch.Tensor], do: torch.Tensor,
               first: torch.Tensor, decay: float) -> None:
    """where(do, where(first, p, decay·avg + (1 − decay)·p), avg) into the
    average, in place, gated by the 0-d device flags `do` and `first`
    (`ema_flags`); reads no host value."""
    a = torch.where(do, torch.where(first, 0.0, decay), 1.0)
    b = torch.where(do, torch.where(first, 1.0, 1.0 - decay), 0.0)
    avg = [local(t) for t in state.params.values()]
    new = [local(params[k].detach()) for k in state.params]
    start, size = 0, 0
    for i, t in enumerate(avg + [None]):
        if (t is None and i > start) or (size and size + t.numel() > EMA_CHUNK):
            torch._foreach_mul_(avg[start:i], a)
            torch._foreach_add_(avg[start:i], torch._foreach_mul(new[start:i], b))
            start, size = i, 0
        if t is not None:
            size += t.numel()


@torch.no_grad()
def ema_update(state: EMAState, params: Mapping[str, torch.Tensor], step: int,
               decay: float = 0.999, start_step: int = 100, every: int = 4) -> EMAState:
    """Fold `params` into the average at this step, when the gating says so:
    psd_tpu's `ema_update`, for callers stepping by hand (the train step
    calls `ema_gate`, `ema_flags` and `ema_apply_` itself)."""
    do = ema_gate(step, start_step, every)
    dev = next(iter(state.params.values())).device
    ema_apply_(state, params, *ema_flags(state, do, dev), decay=decay)
    state.count += int(do)
    return state


@contextlib.contextmanager
def swapped_in(module: nn.Module, state: EMAState) -> Iterator[None]:
    """The EMA's tensors in place of `module`'s parameters inside the block,
    the parameters back after it. No copies: the storages are exchanged,
    except for FSDP2's sharded parameters, whose shards are views FSDP2
    gathers from: their values are exchanged in place."""
    params = dict(module.named_parameters())

    def swap():
        with torch.no_grad():
            for name in state.params:
                p = params[name]
                if isinstance(p, DTensor):
                    mine, avg = local(p), local(state.params[name])
                    held = mine.clone()
                    mine.copy_(avg)
                    avg.copy_(held)
                else:
                    p.data, state.params[name] = state.params[name], p.data

    swap()
    state.swapped = True
    try:
        yield
    finally:
        state.swapped = False
        swap()
