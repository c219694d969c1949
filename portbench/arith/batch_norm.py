"""The train-mode BatchNorm elements of a training step from the published
shapes, and BN's byte floor: a train-mode BN must read x and write y in
the forward and read x and dy and write dx in the backward, 5 elements'
bytes in the compute dtype for each element it normalizes. The
STF-LSTM-UNet normalizes ResNet-34's activations over the B*T folded
frames and its decoder's over B; the UNet's DoubleConvs over B; Swin-UNet
has no BatchNorm."""

from __future__ import annotations

from typing import List, Tuple

from portbench.arith.models.stflstm import _out, encoder_sizes

Shape = Tuple[int, int, int]  # (images N, channels C, pixels H*W)


def stflstm_shapes(arch: dict, batch: int, crop: int) -> List[Shape]:
    frames = batch * arch["time_steps"]
    h = _out(crop, 7, 2, 3)
    shapes = [(frames, arch["widths"][0], h * h)]  # the stem
    h = _out(h, 3, 2, 1)
    cin = arch["widths"][0]
    for stage, (blocks, width) in enumerate(zip(arch["stage_sizes"],
                                                arch["widths"])):
        for i in range(blocks):
            stride = 2 if (stage > 0 and i == 0) else 1
            h = _out(h, 3, stride, 1)
            shapes += [(frames, width, h * h)] * 2
            if stride != 1 or cin != width:
                shapes.append((frames, width, h * h))  # the shortcut
            cin = width
    # each decoder block's ResidualConvBlock at its skip's size, then the
    # last one at twice the finest skip's
    sizes = encoder_sizes(arch, crop)
    for (_, skip_h), width in zip(reversed(sizes[:3]),
                                  arch["decoder_widths"][:3]):
        shapes += [(batch, width, skip_h * skip_h)] * 2
    last = 2 * sizes[0][1]
    shapes += [(batch, arch["decoder_widths"][3], last * last)] * 2
    return shapes


def unet_shapes(arch: dict, batch: int, crop: int) -> List[Shape]:
    c = arch["base_c"]
    widths = [c, 2 * c, 4 * c, 8 * c, 16 * c]
    shapes, sizes, h = [], [], crop
    for level, width in enumerate(widths):
        if level > 0:
            h //= 2
        sizes.append(h)
        shapes += [(batch, width, h * h)] * 2
    for level in range(3, -1, -1):
        shapes += [(batch, widths[level], sizes[level] ** 2)] * 2
    return shapes


SHAPES = {"stflstm": stflstm_shapes, "unet": unet_shapes}


def shapes(model: str, arch: dict, batch: int, crop: int) -> List[Shape]:
    """Every train-mode BN of one step of `model` ([] for a model without
    BatchNorm)."""
    fn = SHAPES.get(model)
    return fn(arch, batch, crop) if fn else []


def elements(model: str, arch: dict, batch: int, crop: int) -> int:
    return sum(n * c * hw for n, c, hw in shapes(model, arch, batch, crop))


def floor_bytes(model: str, arch: dict, batch: int, crop: int,
                itemsize: int) -> int:
    return 5 * itemsize * elements(model, arch, batch, crop)
