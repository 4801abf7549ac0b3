from .clip import CLIPVisionConfig, CLIPVisionTower, clip_vit_l14_config, tiny_clip_config
from .layers import CrossAttnMode, timestep_embedding
from .unet import UNet2DCondition, UNetConfig, sd14_unet_config, tiny_unet_config
from .vae import (AutoencoderKL, VAEConfig, VAEDecode, sample_gaussian, sd_vae_config,
                  tiny_vae_config)

__all__ = [
    "CLIPVisionConfig",
    "CLIPVisionTower",
    "clip_vit_l14_config",
    "tiny_clip_config",
    "CrossAttnMode",
    "timestep_embedding",
    "UNet2DCondition",
    "UNetConfig",
    "sd14_unet_config",
    "tiny_unet_config",
    "AutoencoderKL",
    "VAEConfig",
    "VAEDecode",
    "sample_gaussian",
    "sd_vae_config",
    "tiny_vae_config",
]
