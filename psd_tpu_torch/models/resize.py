"""`jax.image.resize(..., "bilinear")` on NHWC tensors.

JAX's bilinear resize samples at half-pixel centres and, where it shrinks,
widens its triangle kernel by the scale (antialiasing); at the borders it
renormalizes the weights that fall inside the image. That is
`F.interpolate(mode="bilinear", align_corners=False, antialias=True)`, in
both directions (tests/test_torch_backbones.py holds them together within
1e-5 in float32). The metric backbones shrink 256² → 224² (VGG) and grow
256² → 299² (Inception). A bf16 input is resized in float32 and rounded
to bf16 once (JAX rounds its weights and the first pass's output to bf16
too, so the two differ by about one bf16 step there).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(images: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, H, W, C) → (B, height, width, C), in the input's dtype."""
    x = images.permute(0, 3, 1, 2).float()
    y = F.interpolate(x, size=(height, width), mode="bilinear", align_corners=False,
                      antialias=True)
    return y.permute(0, 2, 3, 1).to(images.dtype)
