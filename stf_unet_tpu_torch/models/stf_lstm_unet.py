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
  * With PK maps (use_pk_maps=True) the input carries the pk_channels maps
    (Ktrans, ve, vp) as extra planes after the T frames. They are
    concatenated to every frame's input (conv1 takes 1 + pk_channels
    channels) and fused again after the encoder at each scale: resized to
    the scale (align_corners bilinear), concatenated to the features and
    brought back to the scale's width by a 1x1 conv `pk_fusion{i}`
    (ref:117-121, 146-200).

With remat=True the encoder runs under torch.utils.checkpoint (the JAX
package's nn.remat over it, stf_unet_tpu/models/stf_lstm_unet.py:115-119):
its activations are dropped after the forward and recomputed in the
backward. The recompute runs the BN layers in train mode again, with the
same batch statistics, but updates no running buffer
(blocks.frozen_running_stats), so a step moves them once, as flax's
remat does; it re-enters the forward's row-sharding plan (spatial
parallelism), so its halo exchanges run again, as GSPMD's remat does.

The encoder's modules sit at the top level of this module (conv1, bn1,
layer1..layer4), as in the reference state_dict, so this class extends
ResNet34Encoder rather than holding one.

Dtype policy: parameters stay float32; `dtype` is the compute dtype that
activations and (cast-on-use) weights run in.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator

import torch
import torch.nn as nn
import torch.utils.checkpoint

from stf_unet_tpu_torch.models.blocks import (ConvTranspose, DecoderBlock,
                                              ResidualConvBlock,
                                              batch_running_var_updates,
                                              frozen_running_stats)
from stf_unet_tpu_torch.models.resnet import ResNet34Encoder
from stf_unet_tpu_torch.ops import conv as conv_lib
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
                 use_pk_maps: bool = False, pk_channels: int = 3,
                 lstm_backend: str = "auto",
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        extra = pk_channels if use_pk_maps else 0
        super().__init__(in_channels=1 + extra)
        self.pk_channels = extra
        self.num_classes = num_classes
        self.time_steps = time_steps
        self.use_pk_maps = use_pk_maps
        self.compute_dtype = dtype
        self.remat = remat
        for i, width in enumerate(_SCALE_WIDTHS):
            if use_pk_maps:
                setattr(self, f"pk_fusion{i + 1}",
                        Conv2d(width + pk_channels, width, 1))
            setattr(self, f"lstm{i + 1}", PixelLSTM(width, lstm_backend))
        self.decoder4 = DecoderBlock(512, 256, 256)
        self.decoder3 = DecoderBlock(256, 128, 128)
        self.decoder2 = DecoderBlock(128, 64, 64)
        self.upconv1 = ConvTranspose(64, 32)
        self.final_res = ResidualConvBlock(32, 32)
        self.final = Conv2d(32, num_classes, 1)
        batch_running_var_updates(self)

    def set_lstm_backend(self, backend: str) -> None:
        for i in range(len(_SCALE_WIDTHS)):
            getattr(self, f"lstm{i + 1}").backend = backend

    def _encode(self, folded: torch.Tensor):
        if not (self.remat and self.training and torch.is_grad_enabled()):
            return super().forward(folded)
        plan = conv_lib.row_handler()
        return torch.utils.checkpoint.checkpoint(
            super().forward, folded, use_reentrant=False,
            preserve_rng_state=False,
            context_fn=lambda: (contextlib.nullcontext(),
                                _recompute_scope(plan)))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x: [B, T(+pk_channels), H, W, C] frames (C=1 for DCE-MRI) ->
        {"out": float32 logits [B, H, W, num_classes]}, the JAX package's
        layout."""
        bsz, total_steps, height, width, chans = x.shape
        t_steps = total_steps - self.pk_channels
        frames = x[:, :t_steps].to(self.compute_dtype).permute(0, 1, 4, 2, 3)
        pk_maps = None
        if self.use_pk_maps:
            # [B, pk, H, W, 1] -> [B, pk, H, W], tiled onto every frame
            pk_maps = x[:, t_steps:, :, :, 0]
            frames = torch.cat([frames, pk_maps.to(self.compute_dtype)[
                :, None].expand(bsz, t_steps, -1, -1, -1)], dim=2)
        folded = frames.reshape(bsz * t_steps, frames.shape[2], height, width)
        fused = []
        for i, feat in enumerate(self._encode(folded)):
            _, c, h, w = feat.shape
            if pk_maps is not None:
                # the same 1x1 conv for every t, so the folded batch is the
                # reference's per-t loop
                pk_r = resize_bilinear_align_corners(pk_maps, h, w)
                pk_r = pk_r.to(feat.dtype)[:, None].expand(
                    bsz, t_steps, -1, -1, -1).reshape(bsz * t_steps, -1, h, w)
                feat = getattr(self, f"pk_fusion{i + 1}")(
                    torch.cat([feat, pk_r], dim=1))
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


@contextlib.contextmanager
def _recompute_scope(plan) -> Iterator[None]:
    """The encoder's recompute: no BN buffer update, and the row-sharding
    plan of the forward it repeats (None outside spatial parallelism)."""
    with frozen_running_stats(), conv_lib.rows(plan):
        yield
