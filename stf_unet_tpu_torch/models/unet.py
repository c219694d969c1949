"""Vanilla 2-D UNet (counterpart of stf_unet_tpu/models/unet.py;
ref:src/unet.py:5-57).

Takes the T temporal frames (and, with PK maps, the maps after them) as
stacked channels (input_format="flat_channels": [B, H, W, T*C]); encoder
widths base_c * (1, 2, 4, 8), a base_c * 16 bottleneck, ConvTranspose
k2 s2 upsampling, skip concatenations and a 1x1 head. The max pools are
`F.max_pool2d(x, 2)`, which floors the output size as the JAX package's
`max_pool_torch` does.

Dtype policy, as STFLSTMUNet's: parameters stay float32; `dtype` is the
compute dtype that activations and (cast-on-use) weights run in. The
logits come back float32 [B, H, W, num_classes].
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from stf_unet_tpu_torch.models.blocks import (DoubleConv,
                                              batch_running_var_updates)
from stf_unet_tpu_torch.ops.conv import Conv2d, ConvTranspose2d


class UNet(nn.Module):
    input_format = "flat_channels"

    def __init__(self, in_channels: int = 8, num_classes: int = 2,
                 base_c: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.base_c = base_c
        self.compute_dtype = dtype
        c = base_c
        self.enc1 = DoubleConv(in_channels, c)
        self.enc2 = DoubleConv(c, c * 2)
        self.enc3 = DoubleConv(c * 2, c * 4)
        self.enc4 = DoubleConv(c * 4, c * 8)
        self.bottleneck = DoubleConv(c * 8, c * 16)
        for i, width in ((4, c * 8), (3, c * 4), (2, c * 2), (1, c)):
            setattr(self, f"up{i}", ConvTranspose2d(width * 2, width, 2,
                                                    stride=2))
            setattr(self, f"dec{i}", DoubleConv(width * 2, width))
        self.out_conv = Conv2d(c, num_classes, 1)
        batch_running_var_updates(self)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: [B, H, W, Cin] -> {"out": float32 logits [B, H, W,
        num_classes]}."""
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2)
        e1 = self.enc1(x)
        e2 = self.enc2(F.max_pool2d(e1, 2))
        e3 = self.enc3(F.max_pool2d(e2, 2))
        e4 = self.enc4(F.max_pool2d(e3, 2))
        d = self.bottleneck(F.max_pool2d(e4, 2))
        for i, skip in ((4, e4), (3, e3), (2, e2), (1, e1)):
            d = getattr(self, f"up{i}")(d)
            d = getattr(self, f"dec{i}")(torch.cat([d, skip], dim=1))
        out = self.out_conv(d)
        return {"out": out.permute(0, 2, 3, 1).to(torch.float32)}
