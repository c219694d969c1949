"""STF-LSTM-UNet (counterpart of stf_unet_tpu/models/stf_lstm_unet.py).

Topology, as in the JAX package:
  * ResNet-34 encoder run ONCE over the folded [B*T, 1, H, W] frames.
    Convolutions and eval-mode BN compute the same as a per-frame loop;
    in training, BN's batch statistics are taken over all B*T frames
    rather than per time step (the JAX package's documented divergence
    from the reference).
  * Per-pixel LSTM temporal fusion at each of the 4 scales; the last step
    feeds the decoder (ops/lstm.pixel_lstm, kernels K1/K3 on CUDA).
  * Decoder: 3x DecoderBlock, ConvT k3 s2 + ResidualConvBlock + 1x1 head.
  * The logits are bilinearly upsampled (align_corners=True) to the input
    resolution and returned in float32 (the JAX package's fix of the
    reference's half-resolution head).

The encoder's modules sit at the top level of this module (conv1, bn1,
layer1..layer4), as in the reference state_dict, so this class extends
ResNet34Encoder rather than holding one.

Dtype policy: parameters stay float32; `dtype` is the compute dtype that
activations and (cast-on-use) weights run in. The PK-maps variant is not
ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from stf_unet_tpu_torch.models.blocks import (ConvTranspose, DecoderBlock,
                                              ResidualConvBlock)
from stf_unet_tpu_torch.models.resnet import ResNet34Encoder
from stf_unet_tpu_torch.ops.conv import Conv2d
from stf_unet_tpu_torch.ops.lstm import pixel_lstm
from stf_unet_tpu_torch.ops.resize import resize_bilinear_align_corners

_SCALE_WIDTHS = (64, 128, 256, 512)


class PixelLSTM(nn.Module):
    """One scale's LSTM with torch nn.LSTM parameter names and layout
    ([4C, C] weights, separate b_ih / b_hh) and init uniform(-k, k),
    k = 1/sqrt(C). The forward never calls nn.LSTM: it runs pixel_lstm."""

    def __init__(self, features: int, backend: str = "auto"):
        super().__init__()
        c = features
        bound = 1.0 / c ** 0.5

        def param(*shape):
            return nn.Parameter(torch.empty(shape).uniform_(-bound, bound))

        self.weight_ih_l0 = param(4 * c, c)
        self.weight_hh_l0 = param(4 * c, c)
        self.bias_ih_l0 = param(4 * c)
        self.bias_hh_l0 = param(4 * c)
        self.backend = backend

    def forward(self, feat_seq: torch.Tensor) -> torch.Tensor:
        """[B, T, H, W, C] -> [B, H, W, C] in feat_seq's dtype."""
        dt = feat_seq.dtype
        bias = (self.bias_ih_l0 + self.bias_hh_l0).to(dt)  # folded in f32
        return pixel_lstm(feat_seq, self.weight_ih_l0.t().to(dt),
                          self.weight_hh_l0.t().to(dt), bias,
                          backend=self.backend, train=self.training)


class STFLSTMUNet(ResNet34Encoder):
    input_format = "time_sequence"

    def __init__(self, num_classes: int = 2, time_steps: int = 8,
                 use_pk_maps: bool = False, lstm_backend: str = "auto",
                 dtype: torch.dtype = torch.float32):
        if use_pk_maps:
            raise NotImplementedError(
                "STF-LSTM-UNet with PK maps is not ported yet (ROADMAP.md, "
                "'PK maps branch')")
        super().__init__(in_channels=1)
        self.num_classes = num_classes
        self.time_steps = time_steps
        self.compute_dtype = dtype
        for i, width in enumerate(_SCALE_WIDTHS):
            setattr(self, f"lstm{i + 1}", PixelLSTM(width, lstm_backend))
        self.decoder4 = DecoderBlock(512, 256, 256)
        self.decoder3 = DecoderBlock(256, 128, 128)
        self.decoder2 = DecoderBlock(128, 64, 64)
        self.upconv1 = ConvTranspose(64, 32)
        self.final_res = ResidualConvBlock(32, 32)
        self.final = Conv2d(32, num_classes, 1)

    def set_lstm_backend(self, backend: str) -> None:
        for i in range(len(_SCALE_WIDTHS)):
            getattr(self, f"lstm{i + 1}").backend = backend

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: [B, T, H, W, C] frames (C=1 for DCE-MRI) -> {"out": float32
        logits [B, H, W, num_classes]}, the JAX package's layout."""
        bsz, t_steps, height, width, chans = x.shape
        folded = (x.to(self.compute_dtype).permute(0, 1, 4, 2, 3)
                  .reshape(bsz * t_steps, chans, height, width))
        fused = []
        for i, feat in enumerate(super().forward(folded)):
            _, c, h, w = feat.shape
            seq = feat.reshape(bsz, t_steps, c, h, w).permute(0, 1, 3, 4, 2)
            out = getattr(self, f"lstm{i + 1}")(seq)
            fused.append(out.permute(0, 3, 1, 2))
        f1, f2, f3, f4 = fused

        d4 = self.decoder4(f4, f3)
        d3 = self.decoder3(d4, f2)
        d2 = self.decoder2(d3, f1)
        out = self.final(self.final_res(self.upconv1(d2)))
        if out.shape[-2:] != (height, width):
            out = resize_bilinear_align_corners(out, height, width)
        return {"out": out.permute(0, 2, 3, 1).to(torch.float32)}
