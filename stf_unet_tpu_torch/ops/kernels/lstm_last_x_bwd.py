"""K1b: backward of the last-step pixel LSTM (the VJP of K1).

Replaces both TPU backward kernels of `stf_unet_tpu/ops/pallas/
lstm_train_kernel.py`, which compute the same function and differ only in
VMEM tiling: `_bwd_call_ti` (kernel body `_make_bwd_kernel_ti`, the one
the TPU takes at the training shapes) and `_bwd_call` (body
`_make_bwd_kernel`, its fallback), with the hand-written CUDA kernel
`csrc/lstm_last_x_bwd.cu`.

x [T, N, C], w_ih / w_hh [C, 4C] (the JAX layout, gate order i, f, g, o),
b [4C], dh [N, C] (the cotangent of h_T) -> (dx [T, N, C] in x's dtype,
dW_ih [C, 4C], dW_hh [C, 4C], db [4C], all three f32). Rounding points
are the TPU kernel's: the recomputed gates use h rounded to x's dtype,
dW_hh uses the unrounded f32 h, dx is rounded to x's dtype.

Bound on the H100: operations, 48*T*N*C^2 per call (78.9 GFLOP at both
training shapes, C=64/N=50176 and C=128/N=12544 at T=8): 0.080 ms at the
989 TFLOP/s bf16 peak. The design keeps h, c and dgates in an f32 global
scratch, a floor of its own of ~0.48 / 0.25 ms per call at those shapes.

Which products take tensor cores (`tensor_core_tile`, `TC_TILE_C`): the
bf16 instantiation, the training dtype, forms them with WMMA bf16
products and f32 accumulators. The gate recomputes take exactly-bf16
operands (x_t, round(h_{t-1}), W) unsplit, which is the TPU's rounding
point. dh, dx and the dW sums take the f32 dgates split into bf16
hi = bf16(v) and lo = bf16(v - hi), and dW_hh also the f32 h split so
(hi*hi + hi*lo + lo*hi). A product of two bf16 values is exact in f32,
so only the dropped lo*lo term (2^-16 relative) and the sum order differ
from f32; without the lo terms dW would miss by ~2e-3 of its max. The
tile kernel takes tensor cores at the two fused training widths, C = 64
and 128 (C/16 warps to a block), the CUDA-core tile kernel in bf16 at
every other C; the dW pass takes them at every C. The f32 instantiation runs
every product on CUDA cores in f32 FMA. Times are in PERF.md.

The dW partials are written per block and summed in a fixed order by a
second hand-written pass, so the result is deterministic. On a CPU tensor
the wrapper runs `lstm_last_x_bwd_plain`; on a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from stf_unet_tpu_torch.ops.kernels import build

_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
# Blocks of the dW pass the splits aim at: ~4 per SM of the H100's 132.
_DW_BLOCKS = 528
_DW_TILE = 64
# Output tile (k rows x columns) of the bf16 tensor-core dW pass: kTcK x
# kTcCols in csrc/lstm_last_x_bwd.cu.
_DW_TC_TILE = (64, 128)
# Widths whose bf16 tile kernel runs on tensor cores (the .cu instantiates
# lstm_bwd_tile_tc_kernel for these and refuses any other C).
TC_TILE_C = (64, 128)

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def lstm_last_x_bwd_plain(x: torch.Tensor, w_ih: torch.Tensor,
                          w_hh: torch.Tensor, b: torch.Tensor,
                          dh: torch.Tensor) -> Grads:
    """The kernel's function in plain PyTorch, with its rounding points
    (module docstring): a forward replay that keeps h and c in f32, then
    the reverse walk of the TPU kernel's backward phase."""
    f32 = torch.float32
    t_steps, n, c = x.shape
    wi, wh, bias = w_ih.to(f32), w_hh.to(f32), b.to(f32)
    xf = x.to(f32)

    def gates_at(t, h_prev):
        return (xf[t] @ wi + h_prev.to(x.dtype).to(f32) @ wh) + bias

    zeros = torch.zeros((n, c), dtype=f32, device=x.device)
    hs, cs = [], []
    h, cst = zeros, zeros
    for t in range(t_steps):
        i, f, g, o = _activations(gates_at(t, h))
        cst = f * cst + i * g
        h = o * torch.tanh(cst)
        hs.append(h)
        cs.append(cst)

    dh_t = dh.to(f32)
    dc_carry = zeros
    dx = torch.empty_like(x)
    dwi = torch.zeros((c, 4 * c), dtype=f32, device=x.device)
    dwh = torch.zeros_like(dwi)
    db = torch.zeros((4 * c,), dtype=f32, device=x.device)
    for t in range(t_steps - 1, -1, -1):
        h_prev = hs[t - 1] if t > 0 else zeros
        c_prev = cs[t - 1] if t > 0 else zeros
        i, f, g, o = _activations(gates_at(t, h_prev))
        tanh_c = torch.tanh(cs[t])
        do = dh_t * tanh_c
        dc = dc_carry + dh_t * o * (1.0 - tanh_c ** 2)
        dgates = torch.cat([dc * g * i * (1.0 - i),
                            dc * c_prev * f * (1.0 - f),
                            dc * i * (1.0 - g ** 2),
                            do * o * (1.0 - o)], dim=1)
        dh_t = dgates @ wh.t()
        dc_carry = dc * f
        dx[t] = (dgates @ wi.t()).to(x.dtype)
        dwi += xf[t].t() @ dgates
        dwh += h_prev.t() @ dgates
        db += dgates.sum(dim=0)
    return dx, dwi, dwh, db


def _activations(gates: torch.Tensor):
    i, f, g, o = gates.chunk(4, dim=1)
    return torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)


def dw_splits(t_steps: int, n: int, c: int, dtype: torch.dtype) -> int:
    """How many row ranges the dW pass cuts the T*N rows into: enough
    blocks to fill the card, at least 1024 rows per range. The f32 pass
    launches one grid per matrix; the bf16 tensor-core pass one grid for
    both."""
    if dtype == torch.bfloat16:
        k_tile, col_tile = _DW_TC_TILE
        blocks_per_split = -(-c // k_tile) * -(-4 * c // col_tile)
    else:
        blocks_per_split = 2 * -(-4 * c // _DW_TILE) * -(-c // _DW_TILE)
    per_split = max(1, _DW_BLOCKS // blocks_per_split)
    return max(1, min(per_split, -(-t_steps * n // 1024)))


def tensor_core_tile(dtype: torch.dtype, c: int) -> bool:
    """Whether the tile kernel runs on tensor cores: bf16 at C in
    TC_TILE_C, a rule on C and never a fallback on failure."""
    return dtype == torch.bfloat16 and c in TC_TILE_C


def lstm_last_x_bwd(x: torch.Tensor, w_ih: torch.Tensor, w_hh: torch.Tensor,
                    b: torch.Tensor, dh: torch.Tensor) -> Grads:
    """(dx, dW_ih, dW_hh, db) of h_T = lstm_last_x(x, w_ih, w_hh, b) for
    the cotangent dh (see module docstring)."""
    if x.device.type == "cpu":
        return lstm_last_x_bwd_plain(x, w_ih, w_hh, b, dh)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_last_x_bwd runs on CUDA or CPU, not "
                         f"{x.device}")
    t_steps, n, c = x.shape
    if x.dtype not in build.DTYPE_CODES:
        raise TypeError(f"lstm_last_x_bwd takes float32 or bfloat16, not "
                        f"{x.dtype}")
    for name, v, shape in (("w_ih", w_ih, (c, 4 * c)),
                           ("w_hh", w_hh, (c, 4 * c)), ("b", b, (4 * c,)),
                           ("dh", dh, (n, c))):
        if tuple(v.shape) != shape or v.dtype != x.dtype \
                or v.device != x.device:
            raise ValueError(f"{name}: expected {shape} {x.dtype} on "
                             f"{x.device}, got {tuple(v.shape)} {v.dtype} "
                             f"on {v.device}")
    if c % 32 or not 32 <= c <= 512:
        raise ValueError(f"lstm_last_x_bwd kernel takes C in 32..512, a "
                         f"multiple of 32; got C={c}")
    lib = build.load("lstm_last_x_bwd", _ARGTYPES)
    x, dh, bias = build.aligned(x), dh.contiguous(), b.contiguous()
    tc_tile = tensor_core_tile(x.dtype, c)
    if tc_tile:  # WMMA fragments of W [C, 4C] as given, and of W^T
        wi, wh = build.aligned(w_ih), build.aligned(w_hh)
        wi_t_ptr = wh_t_ptr = None
    else:
        wi, wh = build.pack_gates(w_ih), build.pack_gates(w_hh)
        # [C(j), C(k), 4]: the transposed products read it coalesced over k
        wi_t = wi.transpose(0, 1).contiguous()
        wh_t = wh.transpose(0, 1).contiguous()
        wi_t_ptr, wh_t_ptr = wi_t.data_ptr(), wh_t.data_ptr()
    splits = dw_splits(t_steps, n, c, x.dtype)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dwi = torch.empty((c, 4 * c), **f32)
    dwh = torch.empty((c, 4 * c), **f32)
    db = torch.empty((4 * c,), **f32)
    hs = torch.empty((t_steps, n, c), **f32)
    cs = torch.empty((t_steps, n, c), **f32)
    dg = torch.empty((t_steps, n, 4 * c), **f32)
    part = torch.empty((splits * (2 * c + 1) * 4 * c,), **f32)
    with torch.cuda.device(x.device):
        status = lib.stf_lstm_last_x_bwd(
            x.data_ptr(), wi.data_ptr(), wh.data_ptr(), wi_t_ptr, wh_t_ptr,
            bias.data_ptr(), dh.data_ptr(), dx.data_ptr(), dwi.data_ptr(),
            dwh.data_ptr(), db.data_ptr(), hs.data_ptr(), cs.data_ptr(),
            dg.data_ptr(), part.data_ptr(), t_steps, n, c, splits,
            build.DTYPE_CODES[x.dtype], int(tc_tile),
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check_status("lstm_last_x_bwd", status)
    lstm_last_x_bwd.launches += 1
    return dx, dwi, dwh, db


lstm_last_x_bwd.launches = 0
