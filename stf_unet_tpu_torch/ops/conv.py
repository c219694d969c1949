"""Convolutions that compute in their input's dtype.

The JAX package keeps parameters in float32 and casts them to the compute
dtype at apply time (flax `dtype=`): a checkpoint loads unchanged and bf16
serving casts on the fly. These subclasses do the same, so the model's
parameters stay float32 while activations may be bfloat16.

Layouts are PyTorch's own (NCHW activations, [out,in,kh,kw] conv weights,
[in,out,kh,kw] transposed-conv weights). The JAX package stores its
transposed-conv kernel as the spatially flipped forward-conv HWIO form;
the flip and the in/out transpose happen once, when weights are converted
(utils/weights.py), and `nn.ConvTranspose2d(k3, s2, p1, output_padding=1)`
then computes the reference's arithmetic, out = (in-1)*2 - 2 + 3 + 1.
The stem's max-pool is `nn.MaxPool2d(3, 2, 1)`, which pads with -inf as
the JAX package's `max_pool_torch` does.

`intercept(table)` is the counterpart of flax's `intercept_methods` for
these convolutions: while it is active, a Conv2d found in `table` runs
`table[conv](conv, x)` in place of its float forward (ops/quant.py's int8
convolution). The table lives in a context variable, so a forward on
another thread is not touched.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Dict, Iterator

import torch
import torch.nn as nn

_INTERCEPT: contextvars.ContextVar = contextvars.ContextVar(
    "conv_intercept", default=None)


@contextlib.contextmanager
def intercept(table: Dict["Conv2d", Callable]) -> Iterator[None]:
    token = _INTERCEPT.set(table)
    try:
        yield
    finally:
        _INTERCEPT.reset(token)


def _cast(p, dtype):
    return None if p is None else p.to(dtype)


class Conv2d(nn.Conv2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        table = _INTERCEPT.get()
        if table is not None and self in table:
            return table[self](self, x)
        return self._conv_forward(x, self.weight.to(x.dtype),
                                  _cast(self.bias, x.dtype))


class ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn.functional.conv_transpose2d(
            x, self.weight.to(x.dtype), _cast(self.bias, x.dtype),
            self.stride, self.padding, self.output_padding, self.groups,
            self.dilation)
