"""Inference/training flag and the per-kernel kill switch.

Counterpart of `psd_tpu/core/mode.py`. The dispatch sites in `models/`
consult these flags on every call (PyTorch runs eagerly, so there is no
trace time to bake them into):

  * `training_mode()` routes every kernel site to its plain PyTorch version.
    The hand-written kernels are forward-only; training waits for their
    backward kernels.
  * `disable_kernels(*names)` routes the named sites to their plain versions
    for an A/B run inside one process (`chip_smoke.py` uses it to hold the
    whole UNet against its plain self). Kernel names: "attention", "split3",
    "ln_proj", "ln_geglu".

`gnproj` (GroupNorm affine fused into proj_in, `psd_tpu/ops/gnproj.py`) has
no port yet. It is disabled by configuration, permanently, until its kernel
lands: `kernel_disabled("gnproj")` is always true, and Transformer2D takes
plain GroupNorm then the proj_in matmul, exactly as `psd_tpu` does inside
`disable_kernels("gnproj")`.
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar

KERNELS = ("attention", "split3", "ln_proj", "ln_geglu")

# Kernels of the TPU package that have no Hopper port yet. Off by
# configuration, never by a fallback.
NOT_PORTED = frozenset({"gnproj"})

_TRAINING: ContextVar[bool] = ContextVar("psd_tpu_torch_training", default=False)
_DISABLED: ContextVar[frozenset] = ContextVar(
    "psd_tpu_torch_disabled_kernels", default=frozenset()
)


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
    unknown = set(names) - set(KERNELS) - NOT_PORTED
    if unknown:
        raise ValueError(f"unknown kernel names: {sorted(unknown)}")
    token = _DISABLED.set(_DISABLED.get() | frozenset(names))
    try:
        yield
    finally:
        _DISABLED.reset(token)


def kernel_disabled(name: str) -> bool:
    return name in NOT_PORTED or name in _DISABLED.get()


def use_kernel(name: str) -> bool:
    """True when the kernel site `name` should call its kernel wrapper."""
    return not is_training() and not kernel_disabled(name)
