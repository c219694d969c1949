"""Shared conv building blocks (counterpart of stf_unet_tpu/models/blocks.py).

NCHW activations. Module and attribute names follow the reference PyTorch
layout (conv_block.{0,1,3,4}, shortcut.{0,1}, up / fusion / res_conv; the
UNet's DoubleConv at .0/.1/.3/.4), so a reference state_dict loads with
strict=True.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from stf_unet_tpu_torch.ops.conv import Conv2d, ConvTranspose2d
from stf_unet_tpu_torch.ops.resize import resize_bilinear_align_corners

# torch convention: running = (1 - momentum)*running + momentum*batch
# (the JAX package's flax momentum 0.9 is the same update).
BN_MOMENTUM = 0.1
BN_EPS = 1e-5


def TorchBatchNorm(features: int) -> nn.BatchNorm2d:
    """BatchNorm2d with torch default hyperparameters. Its parameters stay
    float32; a bfloat16 input is normalized and returned in bfloat16."""
    return nn.BatchNorm2d(features, eps=BN_EPS, momentum=BN_MOMENTUM)


class DoubleConv(nn.Sequential):
    """2x(Conv3x3 with bias -> BN -> ReLU): the UNet conv_block
    (ref:src/unet.py:10-18), convs at .0 / .3 and BNs at .1 / .4."""

    def __init__(self, in_channels: int, features: int):
        super().__init__(
            Conv2d(in_channels, features, 3, padding=1),
            TorchBatchNorm(features),
            nn.ReLU(inplace=True),
            Conv2d(features, features, 3, padding=1),
            TorchBatchNorm(features),
            nn.ReLU(inplace=True),
        )


class ResidualConvBlock(nn.Module):
    """2x(Conv3x3 no-bias -> BN) + projection shortcut, then ReLU
    (ref:src/stf_lstm_unet.py:7-35)."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.conv_block = nn.Sequential(
            Conv2d(in_channels, features, 3, padding=1, bias=False),
            TorchBatchNorm(features),
            nn.ReLU(inplace=True),
            Conv2d(features, features, 3, padding=1, bias=False),
            TorchBatchNorm(features),
        )
        self.shortcut = None
        if in_channels != features:
            self.shortcut = nn.Sequential(
                Conv2d(in_channels, features, 1, bias=False),
                TorchBatchNorm(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.shortcut is None else self.shortcut(x)
        return torch.relu(self.conv_block(x) + residual)


def ConvTranspose(in_channels: int, features: int) -> ConvTranspose2d:
    """The decoder's x2 upsample: ConvTranspose2d(k3, s2, p1, op1)."""
    return ConvTranspose2d(in_channels, features, 3, stride=2, padding=1,
                           output_padding=1)


class DecoderBlock(nn.Module):
    """ConvT k3 s2 p1 op1 upsample -> (bilinear size-fix) -> skip concat ->
    1x1 fusion -> ResidualConvBlock (ref:src/stf_lstm_unet.py:38-68)."""

    def __init__(self, in_channels: int, skip_channels: int, features: int):
        super().__init__()
        self.up = ConvTranspose(in_channels, features)
        self.fusion = Conv2d(features + skip_channels, features, 1)
        self.res_conv = ResidualConvBlock(features, features)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = self.up(x)
        if x.shape[-2:] != skip.shape[-2:]:
            x = resize_bilinear_align_corners(x, skip.shape[-2],
                                              skip.shape[-1])
        return self.res_conv(self.fusion(torch.cat([x, skip], dim=1)))
