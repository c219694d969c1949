"""Tensor-core FLOPs of the vanilla UNet from its published shapes
(XiangFeng-Wen/STF-Unet src/unet.py): 2 per multiply-add of every
convolution and transposed convolution; the T frames enter as channels.
A training step is 3x the forward."""

from __future__ import annotations


def lstm_lanes(arch: dict, batch: int, crop: int):
    """The UNet has no pixel LSTM."""
    return []


def forward_flops(arch: dict, batch: int, crop: int) -> float:
    c = arch["base_c"]
    widths = [c, 2 * c, 4 * c, 8 * c, 16 * c]
    total = 0.0

    def conv(k, cin, cout, h):
        return 2.0 * k * k * cin * cout * h * h * batch

    h, cin = crop, arch["time_steps"]
    sizes = []
    for level, width in enumerate(widths):
        if level > 0:
            h //= 2  # max pool 2, floor
        total += conv(3, cin, width, h) + conv(3, width, width, h)
        sizes.append(h)
        cin = width
    for level in range(3, -1, -1):
        width = widths[level]
        # ConvTranspose k2 s2 over the coarser level's pixels
        total += 2.0 * 4 * widths[level + 1] * width * sizes[level + 1] ** 2 \
            * batch
        total += conv(3, 2 * width, width, sizes[level])
        total += conv(3, width, width, sizes[level])
    total += conv(1, c, arch["num_classes"], crop)
    return total
