"""Plain PyTorch layers of the reference models: float32 arithmetic by
torch's own operators, TF32 off (`exact_float32`), no kernel of the port.

Every convolution, matrix product and normalization takes its operands
and its result through `q`, the precision under test: `None` keeps
float32; `fp8` rounds each to float8 e4m3 (per-tensor scale to the
format's largest value) in the forward and the gradient that flows back
into it to float8 e5m2, the usual float8 training recipe, so that every
activation is held in float8 as the port holds it in bfloat16; `int8`
rounds each, and its gradient, to symmetric per-tensor int8. These are
the controls: the reference one precision below the configuration's
bfloat16 (PERF.md says which each cell's limits were set against)."""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.nn.functional as F

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]
BN_EPS = 1e-5


@contextlib.contextmanager
def exact_float32():
    """TF32 off for cuBLAS and cuDNN within the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _round_fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    top = torch.finfo(dtype).max
    scale = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2)


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)


def _round_int8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / 127.0
    return torch.round(x / scale).clamp(-127, 127) * scale


class _Int8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_int8(x)

    @staticmethod
    def backward(ctx, g):
        return _round_int8(g)


def int8(x: torch.Tensor) -> torch.Tensor:
    """Symmetric per-tensor int8 (scale: the tensor's largest magnitude
    over 127), forward and gradient alike."""
    return _Int8.apply(x)



def _q(q: Quant, x: torch.Tensor) -> torch.Tensor:
    return x if q is None else q(x)


def conv(x, w, b=None, stride=1, padding=0, q: Quant = None):
    return _q(q, F.conv2d(_q(q, x), _q(q, w), b, stride, padding))


def conv_t(x, w, b=None, stride=2, padding=0, output_padding=0,
           q: Quant = None):
    return _q(q, F.conv_transpose2d(_q(q, x), _q(q, w), b, stride, padding,
                                    output_padding))


def matmul(a, b, q: Quant = None):
    return _q(q, _q(q, a) @ _q(q, b))


def batch_norm(x, p: dict, name: str, train: bool, q: Quant = None):
    """Train mode: the batch's own statistics (biased variance); eval
    mode: the running statistics held in p (`<name>.running_mean`,
    `<name>.running_var`)."""
    if train:
        return _q(q, F.batch_norm(x, None, None, p[f"{name}.weight"],
                                  p[f"{name}.bias"], True, 0.0, BN_EPS))
    return _q(q, F.batch_norm(x, p[f"{name}.running_mean"],
                              p[f"{name}.running_var"], p[f"{name}.weight"],
                              p[f"{name}.bias"], False, 0.0, BN_EPS))


def resize_align_corners(x, h, w):
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=True)


def lstm_last_h(lanes, w_ih, w_hh, bias, q: Quant = None):
    """torch.nn.LSTM's cell (gates i, f, g, o) over lanes [T, N, C], h and
    c from zero; the last step's h [N, C]. Weights in nn.LSTM's layout
    [4C, C]; bias = b_ih + b_hh."""
    t_steps, n, c = lanes.shape
    x_proj = matmul(lanes.reshape(t_steps * n, c), w_ih.t(), q).view(
        t_steps, n, 4 * c)
    h = lanes.new_zeros((n, c))
    cs = lanes.new_zeros((n, c))
    for t in range(t_steps):
        gates = x_proj[t] + matmul(h, w_hh.t(), q) + bias
        i, f, g, o = gates.chunk(4, dim=-1)
        cs = _q(q, torch.sigmoid(f) * cs + torch.sigmoid(i) * torch.tanh(g))
        h = _q(q, torch.sigmoid(o) * torch.tanh(cs))
    return h
