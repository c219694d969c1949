"""K3: last-step pixel LSTM from a precomputed input projection.

Replaces the TPU kernel `stf_unet_tpu/ops/pallas/lstm_kernel.py:
fused_lstm_last` (kernel body `_lstm_last_kernel`) with the hand-written
CUDA kernel `csrc/lstm_last.cu`.

x_proj [T, N, 4C] (= x @ W_ih in its own dtype), w_hh [C, 4C] (the JAX
layout, gate order i, f, g, o), b [4C] -> h_T [N, C] in x_proj's dtype.
Gate sums and the (h, c) state are f32, and h stays f32 in the recurrent
product, as in the TPU kernel.

Bound on the H100: operations. At the serving shape (T=8, C=512, N=392
at B=8) the recurrent product is 8*T*N*C^2 = 6.6 GFLOP, 6.7 us at the
989 TFLOP/s bf16 peak, against 12.8 MB of x_proj (3.8 us at 3.35 TB/s).

Which calls take tensor cores (`tensor_core_last`, `TC_LAST_C`): bf16 at
C = 256 and 512. That kernel splits the f32 h into bf16 hi + lo and
forms hi W_hh + lo W_hh with WMMA products and f32 accumulators (2x the
products of the bound), with the units split over the blocks of a
thread-block cluster, each block's W_hh slice resident in its shared
memory and h exchanged through distributed shared memory; W_hh is passed
as given [C, 4C]. f32, and bf16 at any other C, run the CUDA-core kernel
on W_hh repacked [C, C, 4]. A tensor-core call that fails to build or
launch (a cluster the card refuses included) raises, it never falls
back. Design and times: csrc/lstm_last.cu, PERF.md.

On a CPU tensor the wrapper runs `lstm_last_plain`; on a CUDA tensor it
launches the kernel or raises. It has no backward, as the TPU kernel has
none (lstm_kernel.py:76): under grad mode with an input that requires
grad it raises instead of returning a tensor cut from the graph.
"""

from __future__ import annotations

import ctypes

import torch

from stf_unet_tpu_torch.ops.kernels import build

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# Widths whose bf16 K3 runs on tensor cores (the .cu instantiates
# lstm_last_tc_kernel for these and refuses any other C).
TC_LAST_C = (256, 512)


def tensor_core_last(dtype: torch.dtype, c: int) -> bool:
    """Whether K3 runs on tensor cores: bf16 at C in TC_LAST_C, a rule on
    dtype and C and never a fallback on failure."""
    return dtype == torch.bfloat16 and c in TC_LAST_C


def lstm_last_plain(x_proj: torch.Tensor, w_hh: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with its rounding points:
    gates = (x_proj_t + h @ W_hh) + b in f32 with h kept f32, h_T cast to
    x_proj's dtype."""
    f32 = torch.float32
    t_steps, n, four_c = x_proj.shape
    wh, bias = w_hh.to(f32), b.to(f32)
    h = torch.zeros((n, four_c // 4), dtype=f32, device=x_proj.device)
    cs = torch.zeros_like(h)
    for t in range(t_steps):
        gates = (x_proj[t].to(f32) + h @ wh) + bias
        i, f, g, o = gates.chunk(4, dim=1)
        cs = torch.sigmoid(f) * cs + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(cs)
    return h.to(x_proj.dtype)


def lstm_last(x_proj: torch.Tensor, w_hh: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """h_T of the LSTM over x_proj's leading time axis (module docstring)."""
    if torch.is_grad_enabled() and any(
            v.requires_grad for v in (x_proj, w_hh, b)):
        raise RuntimeError(
            "lstm_last (kernel K3) has no backward: train through "
            "pixel_lstm(train=True), which routes to 'fused' or 'scan'")
    if x_proj.device.type == "cpu":
        return lstm_last_plain(x_proj, w_hh, b)
    if x_proj.device.type != "cuda":
        raise ValueError(f"lstm_last runs on CUDA or CPU, not "
                         f"{x_proj.device}")
    t_steps, n, four_c = x_proj.shape
    c = four_c // 4
    if x_proj.dtype not in build.DTYPE_CODES:
        raise TypeError(f"lstm_last takes float32 or bfloat16, not "
                        f"{x_proj.dtype}")
    for name, v, shape in (("w_hh", w_hh, (c, 4 * c)), ("b", b, (4 * c,))):
        if tuple(v.shape) != shape or v.dtype != x_proj.dtype \
                or v.device != x_proj.device:
            raise ValueError(f"{name}: expected {shape} {x_proj.dtype} on "
                             f"{x_proj.device}, got {tuple(v.shape)} "
                             f"{v.dtype} on {v.device}")
    if four_c % 4 or c % 32 or not 32 <= c <= 512:
        raise ValueError(f"lstm_last kernel takes C in 32..512, a multiple "
                         f"of 32; got x_proj width {four_c}")
    tc = tensor_core_last(x_proj.dtype, c)
    # tensor cores: W_hh as given, copied to shared memory in 16-byte runs
    wh = build.aligned(w_hh) if tc else build.pack_gates(w_hh)
    lib = build.load("lstm_last", _ARGTYPES)
    x_proj, bias = x_proj.contiguous(), b.contiguous()
    out = torch.empty((n, c), dtype=x_proj.dtype, device=x_proj.device)
    with torch.cuda.device(x_proj.device):
        status = lib.stf_lstm_last(
            x_proj.data_ptr(), wh.data_ptr(), bias.data_ptr(),
            out.data_ptr(), t_steps, n, c, build.DTYPE_CODES[x_proj.dtype],
            int(tc), torch.cuda.current_stream(x_proj.device).cuda_stream)
    build.check_status("lstm_last", status)
    lstm_last.launches += 1
    return out


lstm_last.launches = 0
