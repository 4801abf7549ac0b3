"""Shared pipeline helpers: model building (with the tiny smoke model), the
`--device` flag's device, the turbo and profile flags, and `pad_batch`.

Counterpart of `psd_tpu/pipelines/common.py`. The turbo flags the port
serves (`--sampler dpm`, `--encoder-stride`, `--cache-mode`, `--vae-quant
int8`) work; ToMe is not ported (ROADMAP.md Queue 1 item 7), so
`--tome-ratio > 0` raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import Config
from ..diffusion.dadd import DADD, DADDCoreConfig, core_config_from, resolve_device
from ..models.clip import tiny_clip_config
from ..models.unet import tiny_unet_config
from ..models.vae import VAEConfig, tiny_vae_config


def build_model(cfg: Config, dtype_str: str = "bf16", tome_ratio: float = 0.0,
                tome_mode: str = "branch", vae_quant: str = "none", device="cuda",
                seed: int = 0, for_training: bool = False) -> DADD:
    """The DADD a config describes, its weights drawn from `seed`; the tiny
    UNet/VAE/CLIP in fp32 when the config sets `model.tiny` (tests, CI);
    with fp32 master weights for `for_training`."""
    if tome_ratio > 0:
        raise NotImplementedError(
            f"--tome-ratio {tome_ratio}: ToMe token merging is not ported "
            "(ROADMAP.md Queue 1 item 7); use --tome-ratio 0")
    if cfg.model.extras.get("tiny", False):
        attn_mode = "split3" if cfg.model.use_routing_gates else "split2"
        core_cfg = DADDCoreConfig(
            unet=tiny_unet_config(attn_mode=attn_mode, num_aoe_tokens=4,
                                  num_image_tokens=4, num_delta_tokens=4),
            embedding_dim=32,
            conditioning_dim=32,
            num_aoe_tokens=4,
            num_image_tokens=4,
            use_routing_gates=cfg.model.use_routing_gates,
            use_feature_purifier=cfg.model.use_feature_purifier,
            use_image_projection_plus=cfg.model.use_image_projection_plus,
            purifier_num_heads=2,
            clip_hidden_dim=32,
            clip_projection_dim=16,
        )
        return DADD(cfg, core_cfg=core_cfg, vae_cfg=tiny_vae_config(),
                    clip_cfg=tiny_clip_config(), dtype=torch.float32, device=device, seed=seed,
                    for_training=for_training)
    dtype = torch.bfloat16 if dtype_str == "bf16" else torch.float32
    core_cfg = core_config_from(cfg, dtype=dtype)
    # the CLIP tower computes in bf16 whatever `dtype_str` says, as psd_tpu's
    return DADD(cfg, core_cfg=core_cfg, vae_cfg=VAEConfig(dtype=dtype, quant=vae_quant),
                device=device, seed=seed, for_training=for_training)


def cli_device(name: str) -> torch.device:
    """--device → the device: 'auto' and 'cuda' are the card, which must
    exist; only 'cpu' is the CPU."""
    dev = resolve_device("cuda" if name == "auto" else name)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"--device must be cuda, cuda:N, auto or cpu, got {name!r}")
    return dev


def add_device_arg(p):
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default; 'auto' is the same) or 'cuda:N' runs on the card "
                        "and fails without one; 'cpu' runs on the CPU")
    return p


def add_turbo_args(p):
    """The opt-in turbo serving flags (defaults: the exact path)."""
    p.add_argument("--encoder-stride", type=int, default=1,
                   help="feature propagation: full forward every N-th step only "
                        "(1 = exact; arXiv:2312.09608). Incompatible with dual-pass CFG")
    p.add_argument("--cache-mode", type=str, default="encoder", choices=["encoder", "deep"],
                   help="what propagates across non-key steps: 'encoder' caches down+mid "
                        "features (Faster Diffusion); 'deep' caches the last-up-block input "
                        "and re-runs the shallow path (DeepCache, arXiv:2310.01407)")
    p.add_argument("--tome-ratio", type=float, default=0.0,
                   help="ToMe token merging (arXiv:2303.17098); not ported: only 0 runs")
    p.add_argument("--tome-mode", type=str, default="branch", choices=["branch", "block"],
                   help="ToMe's merge granularity (with --tome-ratio, not ported)")
    p.add_argument("--sampler", type=str, default="ddim", choices=["ddim", "dpm"],
                   help="'ddim' is reference-exact; 'dpm' = DPM-Solver++(2M) "
                        "(arXiv:2211.01095), 20-25 steps where DDIM wants 50")
    p.add_argument("--vae-quant", type=str, default="none", choices=["none", "int8"],
                   help="'int8': W8A8 convs in the VAE decoder's resblocks where the "
                        "decoder's gate admits them. Inference only; same weights")
    return p


def add_profile_arg(p):
    """`--profile`: a torch.profiler trace under <output-dir>/trace and a
    per-phase wall-clock report at exit (utils/profiling.py)."""
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler Chrome trace to <output-dir>/trace and "
                        "print a per-phase timing report at exit")
    return p


def pad_batch(arrays, full: int):
    """Pad the leading dim of each array to `full` by repeating its last
    element, so a ragged last batch runs at the batch size the rest ran at;
    callers slice outputs back to the real count. → (padded arrays, n_real)."""
    n_real = len(arrays[0])
    if n_real == full:
        return arrays, n_real
    if not 0 < n_real < full:
        raise ValueError(f"pad_batch: {n_real} items do not pad to {full}")
    return [np.concatenate([a, np.repeat(a[-1:], full - n_real, axis=0)], axis=0)
            for a in map(np.asarray, arrays)], n_real
