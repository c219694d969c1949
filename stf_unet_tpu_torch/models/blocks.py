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


class TorchBatchNorm(nn.BatchNorm2d):
    """BatchNorm2d with torch default hyperparameters whose running
    variance moves toward the biased batch variance, as flax's BatchNorm
    (the JAX package's) does; nn.BatchNorm2d moves it toward the unbiased
    one, n / (n - 1) larger, n = the rows per channel. The normalized
    output, eval mode and the state_dict are nn.BatchNorm2d's. Its
    parameters stay float32; a bfloat16 input is normalized and returned
    in bfloat16.

    torch's fused train-mode forward kernels make their update,
    new = (1 - m) * old + m * unbiased; a correction then gives flax's,
        (1 - m) * old + m * biased = new + ((1 - m) * old - new) / n,
    a lerp of new toward (1 - m) * old by 1 / n, made on `.data`: the
    backward keeps the buffer among its inputs (it reads it only in eval
    mode) and must not see its version move. A layer corrects itself
    (two small launches) unless its model's forward hooks
    (`batch_running_var_updates`) hold it: then one foreach pass corrects
    every layer of the model after the forward."""

    def __init__(self, features: int):
        super().__init__(features, eps=BN_EPS, momentum=BN_MOMENTUM)
        # None: correct itself; 0: held by the model's hooks, not run yet
        # in this forward; > 0: held, ran over this many rows
        self.held_rows = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        rows = x.numel() // x.shape[1]
        if self.held_rows == 0:
            self.held_rows = rows
            return super().forward(x)
        keep = self.running_var * (1.0 - self.momentum)
        y = super().forward(x)
        self.running_var.data.lerp_(keep, 1.0 / rows)
        return y


def _hold_running_vars(model: nn.Module, args) -> None:
    layers = [m for m in model.modules() if isinstance(m, TorchBatchNorm)
              and m.training and m.track_running_stats]
    if not layers:
        return
    for m in layers:
        m.held_rows = 0
    with torch.no_grad():
        keep = torch._foreach_mul([m.running_var for m in layers],
                                  [1.0 - m.momentum for m in layers])
    model.__dict__["_held_running_vars"] = (layers, keep)


def _correct_running_vars(model: nn.Module, args, out) -> None:
    layers, keep = model.__dict__.pop("_held_running_vars", ((), ()))
    ran = [i for i, m in enumerate(layers) if m.held_rows]
    if ran:
        torch._foreach_lerp_([layers[i].running_var.data for i in ran],
                             [keep[i] for i in ran],
                             [1.0 / layers[i].held_rows for i in ran])
    for m in layers:
        m.held_rows = None


def batch_running_var_updates(model: nn.Module) -> None:
    """Register the forward hooks that take the running-variance
    correction of every TorchBatchNorm of `model` in one foreach pass per
    train-mode forward (a snapshot before it, the lerp after it) instead
    of two launches per layer. Each layer must run once per forward."""
    model.register_forward_pre_hook(_hold_running_vars)
    model.register_forward_hook(_correct_running_vars)


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
