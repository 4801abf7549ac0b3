"""VGG16 fc7 features (torchvision's layout), the improved precision /
recall backbone.

Counterpart of `psd_tpu/models/vgg.py`, under its flax names (`conv_0` ..
`conv_12`, `fc6`, `fc7`): the 13 3×3 convs with ReLU and five 2×2 max
pools, the flatten in NCHW order (torch's, so torchvision's fc weights line
up: psd_tpu transposes its NHWC activations before the flatten), fc6 and fc7
with ReLU (torchvision's `classifier[:-1]` in eval mode). Computes in its
`dtype` (operands cast at use); parameters stay float32.

Input (B, 224, 224, 3) ImageNet-normalized (`imagenet_normalize`) →
(B, 4096).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

VGG16_LAYOUT = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                512, 512, 512, "M", 512, 512, 512, "M")

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class VGG16Features(nn.Module):
    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        cin, n = 3, 0
        for item in VGG16_LAYOUT:
            if item != "M":
                setattr(self, f"conv_{n}", nn.Conv2d(cin, item, 3, padding=1))
                cin, n = item, n + 1
        self.fc6 = nn.Linear(512 * 7 * 7, 4096)
        self.fc7 = nn.Linear(4096, 4096)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = x.to(dt).permute(0, 3, 1, 2)
        n = 0
        for item in VGG16_LAYOUT:
            if item == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            c = getattr(self, f"conv_{n}")
            x = F.relu(F.conv2d(x, c.weight.to(dt), c.bias.to(dt), 1, 1))
            n += 1
        x = x.flatten(1)  # NCHW order
        for fc in (self.fc6, self.fc7):
            x = F.relu(F.linear(x, fc.weight.to(dt), fc.bias.to(dt)))
        return x


def imagenet_normalize(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) in [0, 1] → ImageNet-normalized, in the input's dtype
    (the constants cast to it first, as psd_tpu's)."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=images.dtype, device=images.device)
    std = torch.tensor(IMAGENET_STD, dtype=images.dtype, device=images.device)
    return (images - mean) / std
