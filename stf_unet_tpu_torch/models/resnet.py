"""ResNet-34 encoder (counterpart of stf_unet_tpu/models/resnet.py).

torchvision's resnet34 topology without avgpool/fc: stem (7x7 s2 + BN +
ReLU + maxpool 3x3 s2 p1), then BasicBlock stages [3, 4, 6, 3] at widths
[64, 128, 256, 512], strides [1, 2, 2, 2]. Returns the four per-scale
feature maps (1/4, 1/8, 1/16, 1/32). Names follow torchvision
(conv1, bn1, layer{1..4}.{i}.{conv1,bn1,conv2,bn2,downsample.{0,1}}).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from stf_unet_tpu_torch.models.blocks import TorchBatchNorm
from stf_unet_tpu_torch.ops.conv import Conv2d, MaxPool2d


class BasicBlock(nn.Module):
    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_channels, features, 3, stride=stride,
                            padding=1, bias=False)
        self.bn1 = TorchBatchNorm(features)
        self.conv2 = Conv2d(features, features, 3, padding=1, bias=False)
        self.bn2 = TorchBatchNorm(features)
        self.downsample = None
        if stride != 1 or in_channels != features:
            self.downsample = nn.Sequential(
                Conv2d(in_channels, features, 1, stride=stride, bias=False),
                TorchBatchNorm(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        return torch.relu(self.bn2(self.conv2(y)) + identity)


class ResNet34Encoder(nn.Module):
    """Input [N, C, H, W] -> ([N, 64, H/4, W/4], [N, 128, H/8, W/8],
    [N, 256, H/16, W/16], [N, 512, H/32, W/32])."""

    def __init__(self, in_channels: int = 1,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 widths: Sequence[int] = (64, 128, 256, 512)):
        super().__init__()
        self.conv1 = Conv2d(in_channels, 64, 7, stride=2, padding=3,
                            bias=False)
        self.bn1 = TorchBatchNorm(64)
        self.maxpool = MaxPool2d(kernel_size=3, stride=2, padding=1)
        prev = 64
        for stage, (blocks, width) in enumerate(zip(stage_sizes, widths)):
            layer = []
            for i in range(blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                layer.append(BasicBlock(prev, width, stride))
                prev = width
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layer))
        self.num_stages = len(stage_sizes)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        feats = []
        for stage in range(self.num_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
            feats.append(x)
        return tuple(feats)
