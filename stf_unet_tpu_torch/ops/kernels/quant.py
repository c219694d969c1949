"""K5 and K6, the hand-written passes of the port's int8 convolution
(ops/quant.int8_conv2d): K5 quantizes x and gathers its patches, the
GEMM's operand; K6 turns the GEMM's int32 accumulators into the output.

No TPU kernel is replaced: the JAX package quantizes with jnp ops and
leaves the int8 convolution, its f32 epilogue included, to XLA
(stf_unet_tpu/ops/quant.py:_int8_conv, :86-102). Eager PyTorch has no
int8 convolution on CUDA and `F.unfold` no int8 CUDA path, so the port
runs the convolution as a GEMM, `torch._int_mm` of K5's patch matrix with
the packed int8 weights, and K6 applies the epilogue in one pass over the
accumulators. The CUDA kernels are `csrc/quant_patches.cu` (K5) and
`csrc/quant_epilogue.cu` (K6).

K5, `quantize_patches`: x [N, C, H, W] (float32 or bfloat16,
NCHW-contiguous or channels-last; any other layout is refused, never
copied), scale (0-d float32, max(sx, 1e-8) / 127 as
ops/quant.activation_scale gives it) -> int8 [rows, Kp], rows >= M =
N*Ho*Wo and Kp >= K = KH*KW*C a multiple of 8:
  P[m, k] = clip(rint(float(x[n, c, oh*sh - ph + dy, ow*sw - pw + dx])
                 / scale), -127, 127),
m = (n*Ho + oh)*Wo + ow, k = (dy*KW + dx)*C + c (a row is KH*KW runs of
C channels; ops/quant.pack_weights packs the weights in the same order);
a tap in the zero padding, the columns past K and the rows past M are 0.
A true division and round half to even, as the JAX package's
`jnp.round(x / sx_scale)`.

K6, `dequant_epilogue`: acc int32 [rows, Np] (contiguous; only the first
m rows and o = len(sw) columns are read), sw float32 [o], scale as above,
bias float32 [o] or None -> [m, o] contiguous in float32 or bfloat16:
  y = float(acc) * (sw * scale) (+ bias), cast,
each step rounded as the JAX package rounds it (stf_unet_tpu/ops/
quant.py:97-102).

Bound on the H100: bytes, for both (K5: x read once, P written once; K6:
the accumulators read once, y written once; over 3.35 TB/s). Design and
times: the .cu files' notes, PERF.md.

On a CPU tensor each wrapper runs its plain twin
(`quantize_patches_plain`, `dequant_epilogue_plain`); on a CUDA tensor it
launches its kernel or raises. Both check their inputs on either device.
Nothing to differentiate: the int8 path is inference only.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from stf_unet_tpu_torch.ops.kernels import build

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 10
             + [ctypes.c_void_p])
_EPILOGUE_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                      + [ctypes.c_void_p])
Pair = Tuple[int, int]


def padded(n: int, multiple: int = 8) -> int:
    """n rounded up to a multiple of `multiple` (the GEMM's K and N)."""
    return -(-n // multiple) * multiple


def conv_out_size(h: int, w: int, kernel_size: Pair, stride: Pair,
                  padding: Pair) -> Pair:
    return ((h + 2 * padding[0] - kernel_size[0]) // stride[0] + 1,
            (w + 2 * padding[1] - kernel_size[1]) // stride[1] + 1)


def quantize_activation(x: torch.Tensor, scale: torch.Tensor
                        ) -> torch.Tensor:
    """clip(round(float(x) / scale), -127, 127) as float32 integers."""
    return torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127)


def quantize_patches_plain(x: torch.Tensor, scale: torch.Tensor,
                           kernel_size: Pair, stride: Pair, padding: Pair,
                           kp: Optional[int] = None,
                           rows: Optional[int] = None) -> torch.Tensor:
    """K5's function in plain PyTorch: quantize in float32, `F.unfold`
    (the values are small integers, exact in float32; its columns run
    (c, dy, dx)), reorder the columns to (dy, dx, c), pad K to kp and the
    rows to `rows`, cast to int8."""
    n, c, h, w = x.shape
    ho, wo = conv_out_size(h, w, kernel_size, stride, padding)
    taps = kernel_size[0] * kernel_size[1]
    k = c * taps
    kp = padded(k) if kp is None else kp
    cols = F.unfold(quantize_activation(x, scale), kernel_size,
                    padding=padding, stride=stride)  # [N, K, Ho*Wo]
    p = cols.reshape(n, c, taps, ho * wo).permute(0, 3, 2, 1).reshape(
        n * ho * wo, k)
    rows = n * ho * wo if rows is None else rows
    return F.pad(p, (0, kp - k, 0, rows - n * ho * wo)).to(torch.int8)


def _taken_layout(x: torch.Tensor) -> bool:
    return (x.is_contiguous()
            or x.is_contiguous(memory_format=torch.channels_last))


def quantize_patches(x: torch.Tensor, scale: torch.Tensor,
                     kernel_size: Pair, stride: Pair, padding: Pair,
                     kp: Optional[int] = None,
                     rows: Optional[int] = None) -> torch.Tensor:
    """int8 patch matrix [rows, Kp] of x (module docstring); kp defaults
    to K rounded up to a multiple of 8, rows to M."""
    if x.dim() != 4 or x.dtype not in build.DTYPE_CODES:
        raise TypeError(f"quantize_patches takes a float32 or bfloat16 "
                        f"[N, C, H, W] tensor, not {x.dtype} "
                        f"{tuple(x.shape)}")
    if not _taken_layout(x):
        raise ValueError(f"quantize_patches takes an NCHW-contiguous or "
                         f"channels-last x, not strides {x.stride()} of "
                         f"shape {tuple(x.shape)}")
    if (scale.dtype != torch.float32 or scale.numel() != 1
            or scale.device != x.device):
        raise ValueError(f"scale: expected one float32 value on {x.device}, "
                         f"got {scale.dtype} {tuple(scale.shape)} on "
                         f"{scale.device}")
    n, c, h, w = x.shape
    ho, wo = conv_out_size(h, w, kernel_size, stride, padding)
    k = c * kernel_size[0] * kernel_size[1]
    kp = padded(k) if kp is None else kp
    m = n * ho * wo
    rows = m if rows is None else rows
    if ho < 1 or wo < 1 or kp % 8 or kp < k or rows < m:
        raise ValueError(f"quantize_patches: no patch matrix for x "
                         f"{tuple(x.shape)}, kernel {kernel_size}, stride "
                         f"{stride}, padding {padding}, kp {kp}, rows {rows}")
    if x.device.type == "cpu":
        return quantize_patches_plain(x, scale, kernel_size, stride,
                                      padding, kp, rows)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_patches runs on CUDA or CPU, not "
                         f"{x.device}")
    out = (torch.empty if rows == m else torch.zeros)(
        (rows, kp), dtype=torch.int8, device=x.device)
    lib = build.load("quant_patches", _ARGTYPES)
    with torch.cuda.device(x.device):
        status = lib.stf_quant_patches(
            x.data_ptr(), scale.data_ptr(), out.data_ptr(),
            build.DTYPE_CODES[x.dtype], n, c, h, w, *x.stride(),
            *kernel_size, *stride, *padding, ho, wo, k, kp,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check_status("quant_patches", status)
    quantize_patches.launches += 1
    return out


quantize_patches.launches = 0


def dequant_epilogue_plain(acc: torch.Tensor, m: int, sw: torch.Tensor,
                           scale: torch.Tensor, bias: Optional[torch.Tensor],
                           dtype: torch.dtype) -> torch.Tensor:
    """K6's function in plain PyTorch, the JAX package's eager chain:
    int32 -> float32, times (sw * scale), plus the bias, cast."""
    y = acc[:m, :sw.shape[0]].to(torch.float32) * (
        sw.to(torch.float32) * scale)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(dtype)


def dequant_epilogue(acc: torch.Tensor, m: int, sw: torch.Tensor,
                     scale: torch.Tensor, bias: Optional[torch.Tensor],
                     dtype: torch.dtype) -> torch.Tensor:
    """[m, o] in `dtype` from the GEMM's accumulators (module docstring)."""
    o = sw.shape[0] if sw.dim() == 1 else -1
    if (acc.dtype != torch.int32 or acc.dim() != 2 or not acc.is_contiguous()
            or not 0 < m <= acc.shape[0] or not 0 < o <= acc.shape[1]):
        raise ValueError(f"dequant_epilogue takes contiguous int32 "
                         f"accumulators of at least {m} rows and {o} "
                         f"columns, not {acc.dtype} {tuple(acc.shape)} "
                         f"strides {acc.stride()}")
    for name, t in (("sw", sw), ("bias", bias)):
        if t is not None and (t.dtype != torch.float32 or t.dim() != 1
                              or t.shape[0] != o or not t.is_contiguous()
                              or t.device != acc.device):
            raise ValueError(f"dequant_epilogue: {name} must be a contiguous "
                             f"float32 [{o}] on {acc.device}, not {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if (scale.dtype != torch.float32 or scale.numel() != 1
            or scale.device != acc.device):
        raise ValueError(f"scale: expected one float32 value on "
                         f"{acc.device}, got {scale.dtype} "
                         f"{tuple(scale.shape)} on {scale.device}")
    if dtype not in build.DTYPE_CODES:
        raise TypeError(f"dequant_epilogue writes float32 or bfloat16, not "
                        f"{dtype}")
    if acc.device.type == "cpu":
        return dequant_epilogue_plain(acc, m, sw, scale, bias, dtype)
    if acc.device.type != "cuda":
        raise ValueError(f"dequant_epilogue runs on CUDA or CPU, not "
                         f"{acc.device}")
    y = torch.empty((m, o), dtype=dtype, device=acc.device)
    lib = build.load("quant_epilogue", _EPILOGUE_ARGTYPES)
    with torch.cuda.device(acc.device):
        status = lib.stf_quant_epilogue(
            acc.data_ptr(), sw.data_ptr(), scale.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            build.DTYPE_CODES[dtype], m, o, acc.shape[1],
            torch.cuda.current_stream(acc.device).cuda_stream)
    build.check_status("quant_epilogue", status)
    dequant_epilogue.launches += 1
    return y


dequant_epilogue.launches = 0
