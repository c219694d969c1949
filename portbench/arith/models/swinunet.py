"""Tensor-core FLOPs of Swin-Unet from its published shapes (Cao et al.,
arXiv:2105.05537; configs/swin_tiny_patch4_window7_224_lite.yaml): 2 per
multiply-add of every Linear, attention product (q k^T and the
probabilities times v, at true window lengths) and convolution. The
model computes at `img_size` whatever the crop (a crop of another side
is resized to it, which is no tensor-core work). A training step is 3x
the forward."""

from __future__ import annotations

from typing import List, Tuple


def lstm_lanes(arch: dict, batch: int, crop: int):
    """Swin-Unet has no pixel LSTM."""
    return []


def attention_blocks(arch: dict) -> List[Tuple[int, int, int, int]]:
    """(windows, heads, tokens a window, head dim) of every Swin block,
    encoder then decoder: one window-attention call each a forward."""
    grid = arch["img_size"] // arch["patch_size"]
    ws, dim = arch["window_size"], arch["embed_dim"]
    out = []
    stages = len(arch["depths"])
    order = list(range(stages)) + list(range(stages - 2, -1, -1))
    for i in order:
        res, width = grid >> i, dim << i
        win = min(ws, res)
        heads = arch["num_heads"][i]
        out += [((res // win) ** 2, heads, win * win, width // heads)] \
            * arch["depths"][i]
    return out


def forward_flops(arch: dict, batch: int, crop: int) -> float:
    size, patch = arch["img_size"], arch["patch_size"]
    dim, depths = arch["embed_dim"], arch["depths"]
    hidden = arch["mlp_ratio"]
    stages = len(depths)
    grid = size // patch

    def linear(tokens, cin, cout):
        return 2.0 * tokens * cin * cout

    total = linear(grid * grid, patch * patch * arch["time_steps"], dim)
    for windows, heads, n, hd in attention_blocks(arch):
        tokens, width = windows * n, heads * hd
        total += (linear(tokens, width, 3 * width)
                  + 2 * linear(tokens, n, width)      # q k^T, p v
                  + linear(tokens, width, width)
                  + 2 * linear(tokens, width, int(width * hidden)))
    for i in range(stages - 1):  # patch merging into stage i + 1
        res = grid >> (i + 1)
        total += linear(res * res, 4 * (dim << i), 2 * (dim << i))
    for j in range(stages - 1):  # the 2x expands, deepest first
        res, width = grid >> (stages - 1 - j), dim << (stages - 1 - j)
        total += linear(res * res, width, 2 * width)
    for i in range(stages - 1):  # the skips' concat linears
        res, width = grid >> i, dim << i
        total += linear(res * res, 2 * width, width)
    total += linear(grid * grid, dim, patch * patch * dim)  # final expand
    total += linear(size * size, dim, arch["num_classes"])   # 1x1 head
    return batch * total
