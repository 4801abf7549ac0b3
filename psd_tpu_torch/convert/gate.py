"""The shape gate of a converted checkpoint: its tree against the port's
module of the published configuration, built on the meta device.

psd_tpu checks a converted tree against `jax.eval_shape` of its flax init
(`scripts/port_weights.py`); the port walks it through the bridge's strict
key and shape check (`from_jax.check_flax_shapes`) against the module that
will load it, with no parameter allocated. The kinds are psd_tpu's gated
ones; the backbones have no gate in either.
"""

from __future__ import annotations

from typing import Mapping

import torch

from .from_jax import check_flax_shapes

GATED_KINDS = ("unet", "unet_split3", "vae", "clip")


def check_converted(kind: str, tree: Mapping) -> None:
    """Raise unless `tree` fills the port's `kind` module at the published
    width (SD v1.4's UNet in plain or split3 mode and its VAE; CLIP
    ViT-L/14) exactly: every parameter once, at its shape, and nothing
    else."""
    from ..models.clip import CLIPVisionTower, clip_vit_l14_config
    from ..models.unet import UNet2DCondition, sd14_unet_config
    from ..models.vae import AutoencoderKL, sd_vae_config

    with torch.device("meta"):
        if kind in ("unet", "unet_split3"):
            mode = "split3" if kind == "unet_split3" else "plain"
            module = UNet2DCondition(sd14_unet_config(attn_mode=mode))
        elif kind == "vae":
            module = AutoencoderKL(sd_vae_config())
        elif kind == "clip":
            module = CLIPVisionTower(clip_vit_l14_config())
        else:
            raise KeyError(f"no shape gate for kind {kind!r} (gated: {', '.join(GATED_KINDS)})")
    check_flax_shapes(tree, module)
