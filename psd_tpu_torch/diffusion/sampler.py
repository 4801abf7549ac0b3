"""DDIM and DPM-Solver++(2M) as Python loops, feature propagation, and
classifier-free guidance.

Counterpart of `psd_tpu/diffusion/sampler.py`. The JAX package compiles each
loop into one `lax.scan`; PyTorch runs eagerly, so a loop enqueues each
step's kernels on the current stream without a host sync (the per-step
coefficients are host numpy fp32 scalars), and a key step is a Python
branch rather than `lax.cond`.

State stays fp32 whatever the model's compute dtype: x0-prediction clamped
to ±x0_clip; the last step returns x0_pred. DDIM takes the deterministic
(eta = 0) update, the serving path's, or the eta-stochastic one
(psd_tpu/diffusion/sampler.py:136-146). Its per-step noise is an input,
`eta_noise` (steps, B, H, W, C) fp32, drawn by the caller outside the loop
as the initial latents are (tests hand it JAX's draws, one
`jax.random.normal` per key of `jax.random.split(eta_key, steps)`); the last
step's is drawn and not used, as in psd_tpu.

Feature propagation (`encoder_stride > 1`): a step is a key step when
`i % stride == 0` or it is the last step. With `cache_mode="encoder"` a key
step runs `encode_fn(x, t, i) → cache` and every step `decode_fn(t, i,
cache) → eps`; with `cache_mode="deep"` (DeepCache) a key step runs
`encode_fn(x, t, i) → (eps, cache)` and the others `decode_fn(x, t, i,
cache) → eps`. Step 0 is a key step, so the cache is always set before use.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from .schedule import NoiseSchedule, ddim_timesteps

# eps_fn(x_t, t_batch_int32, step_index) -> eps, same shape as x_t
EpsFn = Callable[[torch.Tensor, torch.Tensor, int], torch.Tensor]

CACHE_MODES = ("encoder", "deep")


@dataclass(frozen=True)
class SamplerConfig:
    sampling_steps: int = 50
    eta: float = 0.0
    x0_clip: float = 4.0
    # re-run the UNet encoder (or the deep branch) every `encoder_stride`-th
    # step only; 1 = exact reference math
    encoder_stride: int = 1
    cache_mode: str = "encoder"  # "encoder" | "deep"


def _f32(v) -> float:
    """A Python float holding the exact fp32 value: torch applies it to an
    fp32 tensor without further rounding."""
    return float(np.float32(v))


def _propagating_eps(eps_fn, cfg: SamplerConfig, encode_fn, decode_fn):
    """step(x, t_b, i) → fp32 eps, running key and non-key steps as the
    sampler config says (psd_tpu/diffusion/sampler.py:108-128)."""
    stride, steps = cfg.encoder_stride, cfg.sampling_steps
    if cfg.cache_mode not in CACHE_MODES:
        raise ValueError(f"cache_mode must be one of {CACHE_MODES}, got {cfg.cache_mode!r}")
    if stride <= 1:
        return lambda x, t_b, i: eps_fn(x, t_b, i).float()
    if encode_fn is None or decode_fn is None:
        raise ValueError("encoder_stride > 1 requires encode_fn/decode_fn")
    state = {}

    def step(x, t_b, i):
        is_key = i % stride == 0 or i == steps - 1
        if cfg.cache_mode == "deep":
            if is_key:
                eps, state["cache"] = encode_fn(x, t_b, i)
            else:
                eps = decode_fn(x, t_b, i, state["cache"])
        else:
            if is_key:
                state["cache"] = encode_fn(x, t_b, i)
            eps = decode_fn(t_b, i, state["cache"])
        return eps.float()

    return step


def ddim_sample(
    eps_fn: Optional[EpsFn],
    x_init: torch.Tensor,
    schedule: NoiseSchedule,
    cfg: SamplerConfig,
    encode_fn=None,
    decode_fn=None,
    eta_noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Run DDIM from x_init (B, H, W, C); returns fp32 x0 of the last step.
    `eta_noise` (steps, B, H, W, C) is required when cfg.eta > 0."""
    steps = cfg.sampling_steps
    ts = ddim_timesteps(schedule.num_train_timesteps, steps)
    acp = schedule.alphas_cumprod  # fp32 numpy
    one = np.float32(1.0)
    step_eps = _propagating_eps(eps_fn, cfg, encode_fn, decode_fn)
    if cfg.eta > 0.0 and (eta_noise is None
                          or tuple(eta_noise.shape) != (steps,) + tuple(x_init.shape)):
        raise ValueError(f"eta > 0 needs eta_noise of shape {(steps,) + tuple(x_init.shape)}, "
                         f"got {None if eta_noise is None else tuple(eta_noise.shape)}")

    x = x_init.float()
    batch = x.shape[0]
    for i in range(steps):
        t = int(ts[i])
        t_prev = int(ts[i + 1]) if i + 1 < steps else int(ts[-1])
        t_b = torch.full((batch,), t, dtype=torch.int32, device=x.device)
        eps = step_eps(x, t_b, i)

        a_t = acp[t]
        x0 = (x - _f32(np.sqrt(one - a_t)) * eps) / _f32(np.sqrt(a_t))
        x0 = x0.clamp(-cfg.x0_clip, cfg.x0_clip)
        if i == steps - 1:
            return x0

        a_prev = acp[t_prev]
        if cfg.eta == 0.0:
            x = _f32(np.sqrt(a_prev)) * x0 + _f32(np.sqrt(one - a_prev)) * eps
        else:
            sigma = np.float32(cfg.eta) * np.sqrt((one - a_prev) / (one - a_t)
                                                  * (one - a_t / a_prev))
            dir_coef = np.sqrt(np.maximum(one - a_prev - sigma * sigma, np.float32(0.0)))
            x = (_f32(np.sqrt(a_prev)) * x0 + _f32(dir_coef) * eps
                 + _f32(sigma) * eta_noise[i])
    return x


def dpm_sample(
    eps_fn: Optional[EpsFn],
    x_init: torch.Tensor,
    schedule: NoiseSchedule,
    cfg: SamplerConfig,
    encode_fn=None,
    decode_fn=None,
) -> torch.Tensor:
    """DPM-Solver++(2M) (arXiv:2211.01095, Algorithm 2) in the data
    parameterization, as `psd_tpu/diffusion/sampler.py:173-280`:
        h_i = λ(t_i) − λ(t_{i−1}),  λ = log(α/σ),  r_i = h_{i−1}/h_i
        D_i = (1 + 1/(2 r_i))·x0_i − (1/(2 r_i))·x0_{i−1}   (first step: x0_i)
        x_i = (σ_i/σ_{i−1})·x_{i−1} − α_i·(e^{−h_i} − 1)·D_i
    Deterministic; the same x0 clamp as DDIM; the last step returns x0.
    The per-step coefficients are host fp32 scalars."""
    steps = cfg.sampling_steps
    ts = ddim_timesteps(schedule.num_train_timesteps, steps)
    acp = schedule.alphas_cumprod  # fp32 numpy
    one, half = np.float32(1.0), np.float32(0.5)
    step_eps = _propagating_eps(eps_fn, cfg, encode_fn, decode_fn)

    def lam(a):  # λ = 0.5·log(acp/(1−acp)), in fp32
        return half * (np.log(a) - np.log1p(-a))

    x = x_init.float()
    batch = x.shape[0]
    x0_prev, h_prev = None, np.float32(0.0)
    for i in range(steps):
        t = int(ts[i])
        t_next = int(ts[i + 1]) if i + 1 < steps else int(ts[-1])
        t_b = torch.full((batch,), t, dtype=torch.int32, device=x.device)
        eps = step_eps(x, t_b, i)

        a_t = acp[t]
        alpha_t, sigma_t = np.sqrt(a_t), np.sqrt(one - a_t)
        x0 = ((x - _f32(sigma_t) * eps) / _f32(alpha_t)).clamp(-cfg.x0_clip, cfg.x0_clip)
        if i == steps - 1:
            return x0

        a_n = acp[t_next]
        alpha_n, sigma_n = np.sqrt(a_n), np.sqrt(one - a_n)
        h = lam(a_n) - lam(a_t)  # > 0 (noise decreases)
        # 2M correction with the previous x0; the first step (h_prev = 0)
        # is first order (DPM-Solver++(1), DDIM's x0-form update)
        if h_prev > 0:
            c = one / (np.float32(2.0) * (h_prev / h))
            d = _f32(one + c) * x0 - _f32(c) * x0_prev
        else:
            d = x0
        x = _f32(sigma_n / sigma_t) * x - _f32(alpha_n * np.expm1(-h)) * d
        x0_prev, h_prev = x0, h
    return x


def cfg_eps_fn(
    raw_eps_fn: Callable[[torch.Tensor, torch.Tensor, int, torch.Tensor], torch.Tensor],
    embed_cond: torch.Tensor,
    embed_uncond: Optional[torch.Tensor],
    guidance_scale,
) -> EpsFn:
    """EpsFn with optional classifier-free guidance: the cond and uncond
    passes run as ONE UNet call at twice the batch, mixed as eps_u +
    guidance·(eps_c − eps_u) in fp32. The guidance is a 0-d fp32 tensor on
    the eps's device (psd_tpu traces it as an fp32 scalar), so a captured
    program replays at the guidance last copied into it; a number works too
    (the same fp32 product)."""
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
