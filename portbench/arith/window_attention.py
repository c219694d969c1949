"""Operations and bytes of one call of Swin's window attention core
(ops/window_attention: scaled_dot_product_attention over the windows
folded into the heads), forward and backward, from its shapes alone: B
samples, nW windows, `heads` heads, N tokens a window, head dim `hd`,
elements of `item` bytes (2 for bf16). True lengths, not the kernels'
padded tiles; each tensor read or written once; the additive mask
[nW * heads, N, N] once, not once a sample (it broadcasts over the
batch). So no kernel can take less time than these bounds say."""

from __future__ import annotations


def forward(b: int, nw: int, heads: int, n: int, hd: int, item: int = 2):
    """q k^T and the probabilities times v: (flops, bytes); q, k, v and
    the mask read, the output written."""
    rows = b * nw * heads
    flops = 4.0 * rows * n * n * hd
    nbytes = item * (4 * rows * n * hd + nw * heads * n * n)
    return flops, nbytes


def backward(b: int, nw: int, heads: int, n: int, hd: int, item: int = 2):
    """dV = P^T dO, dP = dO V^T, dQ = dS K, dK = dS^T Q: (flops, bytes);
    q, k, v, the output, its gradient and the mask read, dq, dk, dv and
    the mask's gradient (summed over the batch) written."""
    rows = b * nw * heads
    flops = 8.0 * rows * n * n * hd
    nbytes = item * (8 * rows * n * hd + 2 * nw * heads * n * n)
    return flops, nbytes
