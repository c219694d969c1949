"""STF-LSTM-UNet, plain PyTorch, from the published description
(XiangFeng-Wen/STF-Unet src/stf_lstm_unet.py), over a dict of float32
tensors named as the reference's state_dict.

A ResNet-34 encoder runs on every frame; at each of the four scales a
per-pixel LSTM (torch.nn.LSTM's cell) runs over the T frames' features
and its last h feeds the decoder: three blocks of (ConvTranspose k3 s2,
concatenation with the skip, 1x1 fusion, residual conv block), a last
ConvTranspose, a residual block and a 1x1 head.

Departures from the published code, each the configuration's own (the
port's documented choices, which the benchmark holds it to):
  * the encoder runs once over the B*T folded frames, so train-mode BN
    takes its statistics over all B*T frames, not per time step;
  * the logits are resized to the input's size (align_corners bilinear),
    where the published head returns half resolution.
"""

from __future__ import annotations

import torch

from portbench.reference import nn as rnn


def _block(p, name, x, stride, train, q):
    y = rnn.conv(x, p[f"{name}.conv1.weight"], None, stride, 1, q)
    y = torch.relu(rnn.batch_norm(y, p, f"{name}.bn1", train, q))
    y = rnn.conv(y, p[f"{name}.conv2.weight"], None, 1, 1, q)
    y = rnn.batch_norm(y, p, f"{name}.bn2", train, q)
    if f"{name}.downsample.0.weight" in p:
        x = rnn.conv(x, p[f"{name}.downsample.0.weight"], None, stride, 0, q)
        x = rnn.batch_norm(x, p, f"{name}.downsample.1", train, q)
    return torch.relu(y + x)


def _residual(p, name, x, train, q):
    y = rnn.conv(x, p[f"{name}.conv_block.0.weight"], None, 1, 1, q)
    y = torch.relu(rnn.batch_norm(y, p, f"{name}.conv_block.1", train, q))
    y = rnn.conv(y, p[f"{name}.conv_block.3.weight"], None, 1, 1, q)
    y = rnn.batch_norm(y, p, f"{name}.conv_block.4", train, q)
    if f"{name}.shortcut.0.weight" in p:
        x = rnn.conv(x, p[f"{name}.shortcut.0.weight"], None, 1, 0, q)
        x = rnn.batch_norm(x, p, f"{name}.shortcut.1", train, q)
    return torch.relu(y + x)


def _decoder(p, name, x, skip, train, q):
    x = rnn.conv_t(x, p[f"{name}.up.weight"], p[f"{name}.up.bias"], 2, 1, 1,
                   q)
    if x.shape[-2:] != skip.shape[-2:]:
        x = rnn.resize_align_corners(x, *skip.shape[-2:])
    x = rnn.conv(torch.cat([x, skip], 1), p[f"{name}.fusion.weight"],
                 p[f"{name}.fusion.bias"], 1, 0, q)
    return _residual(p, f"{name}.res_conv", x, train, q)


def forward(p: dict, x: torch.Tensor, arch: dict, train: bool,
            q: rnn.Quant = None) -> torch.Tensor:
    """x [B, T, H, W, 1] normalized frames -> float32 logits
    [B, H, W, num_classes]."""
    bsz, t_steps, height, width, _ = x.shape
    f = x.permute(0, 1, 4, 2, 3).reshape(bsz * t_steps, 1, height, width)
    f = rnn.conv(f, p["conv1.weight"], None, 2, 3, q)
    f = torch.relu(rnn.batch_norm(f, p, "bn1", train, q))
    f = torch.nn.functional.max_pool2d(f, 3, 2, 1)
    fused = []
    for stage, blocks in enumerate(arch["stage_sizes"]):
        for i in range(blocks):
            f = _block(p, f"layer{stage + 1}.{i}", f,
                       2 if (stage > 0 and i == 0) else 1, train, q)
        _, c, h, w = f.shape
        lanes = f.reshape(bsz, t_steps, c, h, w).permute(1, 0, 3, 4, 2)
        lanes = lanes.reshape(t_steps, bsz * h * w, c)
        name = f"lstm{stage + 1}"
        last = rnn.lstm_last_h(lanes, p[f"{name}.weight_ih_l0"],
                               p[f"{name}.weight_hh_l0"],
                               p[f"{name}.bias_ih_l0"]
                               + p[f"{name}.bias_hh_l0"], q)
        fused.append(last.reshape(bsz, h, w, c).permute(0, 3, 1, 2))
    f1, f2, f3, f4 = fused
    d = _decoder(p, "decoder4", f4, f3, train, q)
    d = _decoder(p, "decoder3", d, f2, train, q)
    d = _decoder(p, "decoder2", d, f1, train, q)
    d = rnn.conv_t(d, p["upconv1.weight"], p["upconv1.bias"], 2, 1, 1, q)
    d = _residual(p, "final_res", d, train, q)
    out = rnn.conv(d, p["final.weight"], p["final.bias"], 1, 0, q)
    if out.shape[-2:] != (height, width):
        out = rnn.resize_align_corners(out, height, width)
    return out.permute(0, 2, 3, 1).float()
