"""DDIM sampler as a Python loop, and classifier-free guidance.

Counterpart of `psd_tpu/diffusion/sampler.py::ddim_sample` and `cfg_eps_fn`.
The JAX package compiles the loop into one `lax.scan`; PyTorch runs eagerly,
so the loop enqueues each step's kernels on the current stream without a host
sync (the per-step coefficients are host numpy fp32 scalars).

State stays fp32 whatever the model's compute dtype:
  * x0-prediction, clamped to ±x0_clip;
  * the deterministic (eta = 0) DDIM update, the serving path's;
  * the last step returns x0_pred.
The eta-stochastic update, DPM-Solver++ and feature propagation wait.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from .schedule import NoiseSchedule, ddim_timesteps

# eps_fn(x_t, t_batch_int32, step_index) -> eps, same shape as x_t
EpsFn = Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor]


@dataclass(frozen=True)
class SamplerConfig:
    sampling_steps: int = 50
    x0_clip: float = 4.0


def ddim_sample(
    eps_fn: EpsFn,
    x_init: torch.Tensor,
    schedule: NoiseSchedule,
    cfg: SamplerConfig,
) -> torch.Tensor:
    """Run DDIM from x_init (B, H, W, C); returns fp32 x0 of the last step."""
    steps = cfg.sampling_steps
    ts = ddim_timesteps(schedule.num_train_timesteps, steps)
    acp = schedule.alphas_cumprod  # fp32 numpy
    one = np.float32(1.0)

    def f32(v) -> float:
        # a Python float holding the exact fp32 value: torch applies it to an
        # fp32 tensor without further rounding
        return float(np.float32(v))

    x = x_init.float()
    batch = x.shape[0]
    for i in range(steps):
        t = int(ts[i])
        t_prev = int(ts[i + 1]) if i + 1 < steps else int(ts[-1])
        t_b = torch.full((batch,), t, dtype=torch.int32, device=x.device)
        eps = eps_fn(x, t_b, i).float()

        a_t = acp[t]
        x0 = (x - f32(np.sqrt(one - a_t)) * eps) / f32(np.sqrt(a_t))
        x0 = x0.clamp(-cfg.x0_clip, cfg.x0_clip)
        if i == steps - 1:
            return x0

        a_prev = acp[t_prev]
        x = f32(np.sqrt(a_prev)) * x0 + f32(np.sqrt(one - a_prev)) * eps
    return x


def cfg_eps_fn(
    raw_eps_fn: Callable[[torch.Tensor, torch.Tensor, int, torch.Tensor], torch.Tensor],
    embed_cond: torch.Tensor,
    embed_uncond: Optional[torch.Tensor],
    guidance_scale: float,
) -> EpsFn:
    """EpsFn with optional classifier-free guidance: the cond and uncond
    passes run as ONE UNet call at twice the batch."""
    if embed_uncond is None:
        def eps_plain(x, t, i):
            return raw_eps_fn(x, t, i, embed_cond)

        return eps_plain

    embeds_2x = torch.cat([embed_cond, embed_uncond], dim=0)

    def eps_cfg(x, t, i):
        eps2 = raw_eps_fn(torch.cat([x, x]), torch.cat([t, t]), i, embeds_2x)
        eps_c, eps_u = eps2.chunk(2, dim=0)
        return eps_u + guidance_scale * (eps_c - eps_u)

    return eps_cfg
