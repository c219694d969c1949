"""Operations and bytes of one launch of each of the port's kernels, from
its shapes alone: each input byte read once, each output byte written
once, whatever the kernel reads again (the formulas of chip_smoke.py's
`bound_ms` callers, frozen here).

Pixel-LSTM shapes: T steps, N = B*h*w lanes of width C, elements of
`item` bytes (2 for bf16). At one batch B every scale of the STF model
has the same N*C^2 (h*w falls by 4 as C doubles), so every launch of a
kernel in one forward has the same operation count."""

from __future__ import annotations


def lstm_fwd(t: int, n: int, c: int, item: int = 2):
    """K1f (csrc/lstm_last_x.cu): x [T, N, C] @ W_ih and h @ W_hh at every
    step, the last h written. (flops, bytes)."""
    flops = 16.0 * t * n * c * c
    nbytes = item * (t * n * c + 8 * c * c + 4 * c + n * c)
    return flops, nbytes


def lstm_bwd(t: int, n: int, c: int, item: int = 2):
    """K1b (csrc/lstm_last_x_bwd.cu): the forward's gate products again
    plus dx and dW: 3x the forward's. x, W_ih, W_hh, b, dh read; dx
    written in x's dtype, dW_ih, dW_hh, db in float32."""
    flops = 48.0 * t * n * c * c
    nbytes = (item * (2 * t * n * c + 8 * c * c + 4 * c + n * c)
              + 4 * (8 * c * c + 4 * c))
    return flops, nbytes


def lstm_last(t: int, n: int, c: int, item: int = 2):
    """K3 (csrc/lstm_last.cu): the recurrence over a precomputed x_proj
    [T, N, 4C]: h @ W_hh at every step."""
    flops = 8.0 * t * n * c * c
    nbytes = item * (t * n * 4 * c + 4 * c * c + 4 * c + n * c)
    return flops, nbytes


def warp(b: int, cs: int, h: int, w: int, ho: int, wo: int):
    """K2 (csrc/warp.cu): the uint8 source [B, Cs, H, W], the float32
    coordinates gy, gx [B, Ho, Wo] and valid sizes [B, 2] read; the
    float32 bilinear planes [B, Cs-1, Ho, Wo] and nearest plane written.
    No tensor-core work. (flops, bytes)."""
    nbytes = (b * cs * h * w + 4 * (2 * b * ho * wo + 2 * b)
              + 4 * (b * (cs - 1) * ho * wo + b * ho * wo))
    return 0.0, nbytes
