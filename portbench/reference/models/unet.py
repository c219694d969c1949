"""The vanilla UNet, plain PyTorch, from the published description
(XiangFeng-Wen/STF-Unet src/unet.py:5-57), over a dict of float32 tensors
named as the reference's state_dict: four levels of DoubleConv (3x3 conv
with bias, BN, ReLU, twice) with 2x2 max pools, a bottleneck at 16x the
base width, ConvTranspose k2 s2 upsampling, skip concatenations and a 1x1
head. The T frames enter as T channels."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import nn as rnn


def _double(p, name, x, train, q):
    for conv_i, bn_i in ((0, 1), (3, 4)):
        x = rnn.conv(x, p[f"{name}.{conv_i}.weight"],
                     p[f"{name}.{conv_i}.bias"], 1, 1, q)
        x = torch.relu(rnn.batch_norm(x, p, f"{name}.{bn_i}", train, q))
    return x


def forward(p: dict, x: torch.Tensor, arch: dict, train: bool,
            q: rnn.Quant = None) -> torch.Tensor:
    """x [B, T, H, W, 1] normalized frames -> float32 logits
    [B, H, W, num_classes]."""
    bsz, t_steps, height, width, _ = x.shape
    h = x[..., 0]  # [B, T, H, W]: the frames as channels
    skips = []
    for i in range(1, 5):
        h = _double(p, f"enc{i}", h, train, q)
        skips.append(h)
        h = F.max_pool2d(h, 2)
    h = _double(p, "bottleneck", h, train, q)
    for i in (4, 3, 2, 1):
        h = rnn.conv_t(h, p[f"up{i}.weight"], p[f"up{i}.bias"], 2, 0, 0, q)
        h = _double(p, f"dec{i}", torch.cat([h, skips[i - 1]], 1), train, q)
    out = rnn.conv(h, p["out_conv.weight"], p["out_conv.bias"], 1, 0, q)
    return out.permute(0, 2, 3, 1).float()
