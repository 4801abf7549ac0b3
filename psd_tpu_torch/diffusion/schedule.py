"""DDPM noise schedule, q-sample, min-SNR weighting and the DDIM grid.

Counterpart of `psd_tpu/diffusion/schedule.py`: the same fp32 numpy buffers,
built on the host. The sampler reads them as numpy fp32 scalars, so the
per-step coefficients are bit-identical to the JAX package's. The train-time
`q_sample` and `min_snr_weight` gather them per sample from copies made once
on the schedule's `device` (the model's): a gather there copies nothing from
the host, so the train step neither waits on the host nor breaks a CUDA
graph's capture.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass(frozen=True)
class NoiseSchedule:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    kind: str = "linear"
    device: torch.device = field(default=torch.device("cpu"), compare=False)

    alphas_cumprod: np.ndarray = field(init=False, repr=False, compare=False)
    snr: np.ndarray = field(init=False, repr=False, compare=False)
    # the two tables as fp32 tensors on `device`, by name
    tables: dict = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        if self.kind != "linear":
            raise NotImplementedError(f"Only linear schedule supported, got {self.kind}")
        betas = np.linspace(
            self.beta_start, self.beta_end, self.num_train_timesteps, dtype=np.float32
        )
        acp = np.cumprod((1.0 - betas).astype(np.float64), axis=0).astype(np.float32)
        object.__setattr__(self, "alphas_cumprod", acp)
        object.__setattr__(self, "snr", acp / (1.0 - acp + 1e-8))
        object.__setattr__(self, "device", torch.device(self.device))
        object.__setattr__(self, "tables", {
            name: torch.from_numpy(getattr(self, name)).to(self.device)
            for name in ("alphas_cumprod", "snr")})

    def _gather(self, name: str, t: torch.Tensor) -> torch.Tensor:
        table = self.tables[name]
        if t.device != table.device:
            raise ValueError(f"NoiseSchedule: t on {t.device}, the tables on {table.device}; "
                             f"build the schedule with device={t.device}")
        return table[t.long()]

    def q_sample(self, x0, t, noise):
        """x_t = sqrt(acp_t)·x0 + sqrt(1−acp_t)·noise, t: (B,) int."""
        acp = self._gather("alphas_cumprod", t).to(x0.dtype)
        shape = (-1,) + (1,) * (x0.ndim - 1)
        return torch.sqrt(acp).reshape(shape) * x0 + torch.sqrt(1.0 - acp).reshape(shape) * noise

    def min_snr_weight(self, t, gamma: float = 1.0):
        """min(SNR_t, γ) / (SNR_t + 1e-8); per-sample loss weight."""
        snr = self._gather("snr", t)
        return torch.clamp(snr, max=gamma) / (snr + 1e-8)


def ddim_timesteps(num_train_timesteps: int, sampling_steps: int) -> np.ndarray:
    """DDIM grid linspace(T−1 → 0), computed in float64 and truncated to int."""
    if sampling_steps > num_train_timesteps:
        raise ValueError(
            f"sampling_steps={sampling_steps} must be <= T={num_train_timesteps}"
        )
    vals = np.linspace(num_train_timesteps - 1, 0, sampling_steps, dtype=np.float64)
    return vals.astype(np.int64)
