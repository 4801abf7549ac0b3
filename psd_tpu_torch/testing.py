"""Tiny full-stack factory for tests and smoke runs: the same shapes as
`psd_tpu.testing.tiny_dadd()` (split3 routing, AOE, IP-Plus, purifier),
fp32, seeded flax-style init."""

from __future__ import annotations

import torch

from .core.config import Config
from .diffusion.dadd import DADD, DADDCoreConfig
from .models.unet import tiny_unet_config
from .models.vae import tiny_vae_config


def tiny_dadd(device="cpu", seed=0, for_training=False, **unet_overrides) -> DADD:
    cfg = Config()
    cfg.dataset.image_size = 32
    cfg.diffusion.sampling_steps = 4
    core_cfg = DADDCoreConfig(
        unet=tiny_unet_config(
            attn_mode="split3",
            num_aoe_tokens=4,
            num_image_tokens=4,
            num_delta_tokens=4,
            **unet_overrides,
        ),
        embedding_dim=32,
        conditioning_dim=32,
        num_classes=4,
        num_aoe_tokens=4,
        num_image_tokens=4,
        use_image_projection_plus=True,
        use_feature_purifier=True,
        use_routing_gates=True,
        purifier_num_heads=2,
        clip_hidden_dim=32,
    )
    return DADD(cfg, core_cfg=core_cfg, vae_cfg=tiny_vae_config(), dtype=torch.float32,
                device=device, seed=seed, for_training=for_training)
