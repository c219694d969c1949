"""Tensor-core FLOPs of the STF-LSTM-UNet from its published shapes
(XiangFeng-Wen/STF-Unet src/stf_lstm_unet.py): 2 per multiply-add of
every convolution, transposed convolution and pixel-LSTM gate product.
Normalization, activations, resizes, the loss and the optimizer are not
counted. A training step is 3x the forward."""

from __future__ import annotations


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def encoder_sizes(arch: dict, crop: int):
    """[(C, h)] of the four encoder scales at a square crop."""
    h = _out(_out(crop, 7, 2, 3), 3, 2, 1)  # stem conv, max pool
    sizes = []
    for stage, width in enumerate(arch["widths"]):
        if stage > 0:
            h = _out(h, 3, 2, 1)
        sizes.append((width, h))
    return sizes


def lstm_lanes(arch: dict, batch: int, crop: int):
    """[(C, N)] of the four pixel LSTMs: N = B*h*w lanes of width C."""
    return [(c, batch * h * h) for c, h in encoder_sizes(arch, crop)]


def forward_flops(arch: dict, batch: int, crop: int) -> float:
    t = arch["time_steps"]
    frames = batch * t
    total = 0.0

    def conv(n_img, k, cin, cout, h_out):
        return 2.0 * k * k * cin * cout * h_out * h_out * n_img

    h = _out(crop, 7, 2, 3)
    total += conv(frames, 7, arch["in_channels"], arch["widths"][0], h)
    h = _out(h, 3, 2, 1)
    cin = arch["widths"][0]
    for stage, (blocks, width) in enumerate(zip(arch["stage_sizes"],
                                                arch["widths"])):
        for i in range(blocks):
            stride = 2 if (stage > 0 and i == 0) else 1
            h_out = _out(h, 3, stride, 1)
            total += conv(frames, 3, cin, width, h_out)
            total += conv(frames, 3, width, width, h_out)
            if stride != 1 or cin != width:
                total += conv(frames, 1, cin, width, h_out)
            h, cin = h_out, width
    for c, n in lstm_lanes(arch, batch, crop):
        total += 16.0 * t * n * c * c

    sizes = encoder_sizes(arch, crop)
    (c4, h4) = sizes[3]
    cur_c, cur_h = c4, h4
    for (skip_c, skip_h), width in zip(reversed(sizes[:3]),
                                       arch["decoder_widths"][:3]):
        # ConvTranspose k3 s2: the multiply-adds of each input pixel
        total += 2.0 * 9 * cur_c * width * cur_h * cur_h * batch
        total += conv(batch, 1, width + skip_c, width, skip_h)
        total += 2 * conv(batch, 3, width, width, skip_h)
        cur_c, cur_h = width, skip_h
    last = arch["decoder_widths"][3]
    total += 2.0 * 9 * cur_c * last * cur_h * cur_h * batch
    cur_h *= 2
    total += 2 * conv(batch, 3, last, last, cur_h)
    total += conv(batch, 1, last, arch["num_classes"], cur_h)
    return total
