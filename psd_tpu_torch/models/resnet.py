"""ResNet-18/34/50/101 (torchvision's layout), the MES classifier and judge.

Counterpart of `psd_tpu/models/resnet.py`, under its flax names (`conv1`,
`bn1`, `layer2_0.downsample_conv`, `fc`, ...), so the bridge maps its
`params` and `batch_stats` by name both ways. A dropout head to
`num_classes` logits ("classify"), to one scalar ("regress"), or the pooled
features ("features"). The BatchNorms are flax's (`models/batchnorm.py`:
momentum 0.9, eps 1e-5, the biased batch variance in the running
statistics); `module.train()` normalizes by the batch and updates them,
`eval()` uses them. Computes in float32, as psd_tpu's classifier does.

Input (B, H, W, 3) ImageNet-normalized, NHWC.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .batchnorm import BatchNorm

SPECS = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
}


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, channels: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, channels, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(channels)
        if cin != channels or stride != 1:
            self.downsample_conv = nn.Conv2d(cin, channels, 1, stride, bias=False)
            self.downsample_bn = BatchNorm(channels)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        if hasattr(self, "downsample_conv"):
            x = self.downsample_bn(self.downsample_conv(x))
        return F.relu(x + h)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, channels: int, stride: int = 1):
        super().__init__()
        out = channels * 4
        self.conv1 = nn.Conv2d(cin, channels, 1, bias=False)
        self.bn1 = BatchNorm(channels)
        self.conv2 = nn.Conv2d(channels, channels, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm(channels)
        self.conv3 = nn.Conv2d(channels, out, 1, bias=False)
        self.bn3 = BatchNorm(out)
        if cin != out or stride != 1:
            self.downsample_conv = nn.Conv2d(cin, out, 1, stride, bias=False)
            self.downsample_bn = BatchNorm(out)

    def forward(self, x):
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        if hasattr(self, "downsample_conv"):
            x = self.downsample_bn(self.downsample_conv(x))
        return F.relu(x + h)


@dataclass(frozen=True)
class ResNetConfig:
    variant: str = "resnet18"
    num_classes: int = 4
    head: str = "classify"  # "classify" | "regress" | "features"
    dropout: float = 0.2


class ResNet(nn.Module):
    def __init__(self, config: ResNetConfig = ResNetConfig()):
        super().__init__()
        if config.variant not in SPECS:
            raise ValueError(f"unknown ResNet variant {config.variant!r}; one of {tuple(SPECS)}")
        if config.head not in ("classify", "regress", "features"):
            raise ValueError(f"head must be classify, regress or features, got {config.head!r}")
        self.config = config
        kind, layers = SPECS[config.variant]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64)
        cin = 64
        self.block_names = []
        for i, (n, width) in enumerate(zip(layers, (64, 128, 256, 512))):
            for j in range(n):
                name = f"layer{i + 1}_{j}"
                setattr(self, name, block(cin, width, 2 if (i > 0 and j == 0) else 1))
                cin = width * block.expansion
                self.block_names.append(name)
        if config.head != "features":
            self.fc = nn.Linear(cin, 1 if config.head == "regress" else config.num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        h = x.float().permute(0, 3, 1, 2)
        h = F.relu(self.bn1(self.conv1(h)))
        h = F.max_pool2d(h, 3, 2, 1)
        for name in self.block_names:
            h = getattr(self, name)(h)
        feats = h.mean(dim=(2, 3))
        if cfg.head == "features":
            return feats
        out = self.fc(F.dropout(feats, cfg.dropout, training=self.training))
        return out[:, 0] if cfg.head == "regress" else out


def resnet_feature_dim(variant: str) -> int:
    kind, _ = SPECS[variant]
    return 512 if kind == "basic" else 2048
