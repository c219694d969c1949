"""K1 forward: last-step pixel LSTM with the input projection in the kernel.

Replaces the TPU kernel `stf_unet_tpu/ops/pallas/lstm_train_kernel.py:
_fwd_call` (kernel body `_make_fwd_kernel`, public `fused_lstm_last_x`)
with the hand-written CUDA kernel `csrc/lstm_last_x.cu`.

x [T, N, C], w_ih / w_hh [C, 4C] (the JAX layout, gate order i, f, g, o),
b [4C] -> h_T [N, C] in x's dtype. Gate sums and the (h, c) state are f32;
h is rounded to x's dtype before the recurrent product, as the TPU kernel
does. Only h_T is written: no [T, N, 4C] projection and no h/c sequence
reach device memory.

Bound on the H100: operations. At the serving shapes (T=8; N = B*h*w with
B=8 at C = 64/128/256) the kernel does 16*T*N*C^2 = 13.2 GFLOP per call,
~13 us at the 989 TFLOP/s bf16 peak, against 6.4-25.7 MB of x (2-8 us at
3.35 TB/s).

Which calls take tensor cores (`tensor_core_fwd`, `TC_FWD_C`): bf16 at
C = 64, 128 and 256, the serving and training widths. That kernel forms
the gates with WMMA bf16 products and f32 accumulators from exactly-bf16
operands (x_t, round(h_{t-1}), W as given [C, 4C]): the TPU kernel's
rounding point, with no split; its row tile is fixed per C in the .cu. f32,
and bf16 at any other C, run the CUDA-core kernel on weights repacked
[C, C, 4]; TF32 would miss f32's tolerance. The rule is on dtype and C:
a tensor-core call that fails to build or launch raises, it never falls
back. Design and times: csrc/lstm_last_x.cu, PERF.md.

`lstm_last_x` is differentiable: it applies `LstmLastX`, whose backward is
K1b (ops/kernels/lstm_last_x_bwd.py), with the JAX VJP's casts (dx in x's
dtype, dW and db accumulated in f32 and cast to the weights' dtype,
lstm_train_kernel.py:551-559). On a CPU tensor both directions run their
plain versions; on a CUDA tensor they launch their kernels or raise.
"""

from __future__ import annotations

import ctypes

import torch

from stf_unet_tpu_torch.ops.kernels import build
from stf_unet_tpu_torch.ops.kernels.lstm_last_x_bwd import lstm_last_x_bwd

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# Widths whose bf16 forward runs on tensor cores (the .cu instantiates
# lstm_last_x_tc_kernel for these and refuses any other C).
TC_FWD_C = (64, 128, 256)


def tensor_core_fwd(dtype: torch.dtype, c: int) -> bool:
    """Whether the forward runs on tensor cores: bf16 at C in TC_FWD_C, a
    rule on dtype and C and never a fallback on failure."""
    return dtype == torch.bfloat16 and c in TC_FWD_C


def lstm_last_x_plain(x: torch.Tensor, w_ih: torch.Tensor,
                      w_hh: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with its rounding points:
    products of dtype values summed in f32, h cast to x's dtype before
    h @ W_hh, (h, c) carried in f32, h_T cast to x's dtype."""
    f32 = torch.float32
    t_steps, n, c = x.shape
    wi, wh, bias = w_ih.to(f32), w_hh.to(f32), b.to(f32)
    h = torch.zeros((n, c), dtype=f32, device=x.device)
    cs = torch.zeros_like(h)
    for t in range(t_steps):
        gates = (x[t].to(f32) @ wi + h.to(x.dtype).to(f32) @ wh) + bias
        i, f, g, o = gates.chunk(4, dim=1)
        cs = torch.sigmoid(f) * cs + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(cs)
    return h.to(x.dtype)


def _forward(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
             b: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return lstm_last_x_plain(x, w_ih, w_hh, b)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_last_x runs on CUDA or CPU, not {x.device}")
    t_steps, n, c = x.shape
    if x.dtype not in build.DTYPE_CODES:
        raise TypeError(f"lstm_last_x takes float32 or bfloat16, not "
                        f"{x.dtype}")
    for name, v, shape in (("w_ih", w_ih, (c, 4 * c)),
                           ("w_hh", w_hh, (c, 4 * c)), ("b", b, (4 * c,))):
        if tuple(v.shape) != shape or v.dtype != x.dtype \
                or v.device != x.device:
            raise ValueError(f"{name}: expected {shape} {x.dtype} on "
                             f"{x.device}, got {tuple(v.shape)} {v.dtype} "
                             f"on {v.device}")
    if c % 32 or not 32 <= c <= 512:
        raise ValueError(f"lstm_last_x kernel takes C in 32..512, a "
                         f"multiple of 32; got C={c}")
    tc = tensor_core_fwd(x.dtype, c)
    if tc:  # WMMA fragments of W [C, 4C] as given
        x, wi, wh = (build.aligned(v) for v in (x, w_ih, w_hh))
    else:
        x = x.contiguous()
        wi, wh = build.pack_gates(w_ih), build.pack_gates(w_hh)
    lib = build.load("lstm_last_x", _ARGTYPES)
    bias = b.contiguous()
    out = torch.empty((n, c), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        status = lib.stf_lstm_last_x(
            x.data_ptr(), wi.data_ptr(), wh.data_ptr(), bias.data_ptr(),
            out.data_ptr(), t_steps, n, c, build.DTYPE_CODES[x.dtype],
            int(tc),
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check_status("lstm_last_x", status)
    lstm_last_x.launches += 1
    return out


class LstmLastX(torch.autograd.Function):
    """K1 forward with K1b as its backward."""

    @staticmethod
    def forward(ctx, x, w_ih, w_hh, b):
        ctx.save_for_backward(x, w_ih, w_hh, b)
        return _forward(x, w_ih, w_hh, b)

    @staticmethod
    def backward(ctx, dh):
        x, w_ih, w_hh, b = ctx.saved_tensors
        dx, dwi, dwh, db = lstm_last_x_bwd(x, w_ih, w_hh, b, dh.to(x.dtype))
        return dx, dwi.to(w_ih.dtype), dwh.to(w_hh.dtype), db.to(b.dtype)


def lstm_last_x(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """h_T of the LSTM over x's leading time axis (see module docstring),
    differentiable in all four inputs."""
    return LstmLastX.apply(x, w_ih, w_hh, b)


lstm_last_x.launches = 0
