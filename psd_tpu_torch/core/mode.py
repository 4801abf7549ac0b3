"""Inference/training flag and the per-kernel kill switch.

Counterpart of `psd_tpu/core/mode.py`. The dispatch sites in `models/`
consult these flags on every call (PyTorch runs eagerly, so there is no
trace time to bake them into):

  * `training_mode()` follows `psd_tpu`'s kernel set for the train step.
    Kernels with a backward stay on: `attention` (in the role of the stock
    Pallas flash kernel, whose fused backward psd_tpu trains with,
    `psd_tpu/ops/attention.py:51-57`; here an autograd.Function over the
    forward kernel and the backward kernel of `csrc/attention_bwd.cu`) and
    `split3` (forward kernel, backward through the plain version, as
    `psd_tpu/ops/split3.py:143` back-propagates through XLA math). The fused
    LayerNorm and GroupNorm GEMMs (`ln_proj`, `ln_geglu`, `gn_proj`) take
    their plain versions, as at `psd_tpu/models/layers.py:579` and
    `:595-599`.
  * `disable_kernels(*names)` routes the named sites to their plain versions
    for an A/B run inside one process (`chip_smoke.py` uses it to hold the
    whole UNet, and the train step, against their plain selves).

  * `eager()` is the counterpart of `jax.disable_jit`: under it
    `DADD.generate`, `sample` and `decode_latents` run on the card op by op
    instead of replaying their captured CUDA graphs
    (`diffusion/graphs.py`); `chip_smoke.py` holds graph replay against it.

`snapshot()` / `restored(snap)` carry the flags into gradient-checkpoint
recomputation, which runs inside backward, possibly on the autograd
engine's own thread where these context variables hold their defaults. A
captured graph bakes in the flags it was captured under, so `snapshot()` is
part of every graph's key (psd_tpu puts `is_training()` in its jit keys).
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Tuple

KERNELS = ("attention", "split3", "ln_proj", "ln_geglu", "gn_proj")

# kernels that stay on in training (they have a backward)
TRAINING_KERNELS = frozenset({"attention", "split3"})

_TRAINING: ContextVar[bool] = ContextVar("psd_tpu_torch_training", default=False)
_DISABLED: ContextVar[frozenset] = ContextVar(
    "psd_tpu_torch_disabled_kernels", default=frozenset()
)
_EAGER: ContextVar[bool] = ContextVar("psd_tpu_torch_eager", default=False)


@contextlib.contextmanager
def training_mode():
    token = _TRAINING.set(True)
    try:
        yield
    finally:
        _TRAINING.reset(token)


def is_training() -> bool:
    return _TRAINING.get()


@contextlib.contextmanager
def disable_kernels(*names: str):
    """Route the named kernel sites to their plain PyTorch versions."""
    unknown = set(names) - set(KERNELS)
    if unknown:
        raise ValueError(f"unknown kernel names: {sorted(unknown)}")
    token = _DISABLED.set(_DISABLED.get() | frozenset(names))
    try:
        yield
    finally:
        _DISABLED.reset(token)


def kernel_disabled(name: str) -> bool:
    return name in _DISABLED.get()


def use_kernel(name: str) -> bool:
    """True when the kernel site `name` should call its kernel wrapper."""
    if is_training() and name not in TRAINING_KERNELS:
        return False
    return not kernel_disabled(name)


@contextlib.contextmanager
def eager():
    """Run the entry points op by op on the card, capturing no CUDA graph."""
    token = _EAGER.set(True)
    try:
        yield
    finally:
        _EAGER.reset(token)


def is_eager() -> bool:
    return _EAGER.get()


def snapshot() -> Tuple[bool, frozenset]:
    return _TRAINING.get(), _DISABLED.get()


@contextlib.contextmanager
def restored(snap: Tuple[bool, frozenset]):
    """Re-enter the flags of `snapshot()` (checkpoint recomputation)."""
    t1 = _TRAINING.set(snap[0])
    t2 = _DISABLED.set(snap[1])
    try:
        yield
    finally:
        _DISABLED.reset(t2)
        _TRAINING.reset(t1)
