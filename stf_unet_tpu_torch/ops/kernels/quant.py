"""K5: quantize an activation to int8 and gather its convolution patches,
the operand pass of the port's int8 convolution (ops/quant.int8_conv2d).

No TPU kernel is replaced: the JAX package quantizes with jnp ops and
leaves the int8 convolution to XLA (stf_unet_tpu/ops/quant.py:_int8_conv,
:86). Eager PyTorch has no int8 convolution on CUDA and `F.unfold` no
int8 CUDA path, so the port runs the convolution as a GEMM,
`torch._int_mm` of this pass's patch matrix with the packed int8 weights;
done with eager ops the pass would be five or six passes over a tensor up
to KH*KW times the activation. The hand-written CUDA kernel is
`csrc/quant_patches.cu`.

x [N, C, H, W] (float32 or bfloat16), scale (0-d float32, max(sx, 1e-8) /
127 as ops/quant.activation_scale gives it) -> int8 [rows, Kp], rows >= M
= N*Ho*Wo and Kp >= K = C*KH*KW a multiple of 8:
  P[m, k] = clip(rint(float(x[n, c, oh*sh - ph + dy, ow*sw - pw + dx])
                 / scale), -127, 127),
m = (n*Ho + oh)*Wo + ow, k = (c*KH + dy)*KW + dx (the torch weight
order); a tap in the zero padding, the columns past K and the rows past M
are 0. A true division and round half to even, as the JAX package's
`jnp.round(x / sx_scale)`.

Bound on the H100: bytes (x read once, P written once, over 3.35 TB/s).
Design and times: csrc/quant_patches.cu, PERF.md.

On a CPU tensor the wrapper runs `quantize_patches_plain`; on a CUDA
tensor it launches the kernel or raises. The output is int8: nothing to
differentiate.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from stf_unet_tpu_torch.ops.kernels import build

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 15 + [ctypes.c_void_p]
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
    """The kernel's function in plain PyTorch: quantize in float32,
    `F.unfold` (the values are small integers, exact in float32), pad
    K to kp and the rows to `rows`, cast to int8."""
    n, c, h, w = x.shape
    ho, wo = conv_out_size(h, w, kernel_size, stride, padding)
    k = c * kernel_size[0] * kernel_size[1]
    kp = padded(k) if kp is None else kp
    cols = F.unfold(quantize_activation(x, scale), kernel_size,
                    padding=padding, stride=stride)  # [N, K, Ho*Wo]
    p = cols.transpose(1, 2).reshape(n * ho * wo, k)
    rows = n * ho * wo if rows is None else rows
    return F.pad(p, (0, kp - k, 0, rows - n * ho * wo)).to(torch.int8)


def quantize_patches(x: torch.Tensor, scale: torch.Tensor,
                     kernel_size: Pair, stride: Pair, padding: Pair,
                     kp: Optional[int] = None,
                     rows: Optional[int] = None) -> torch.Tensor:
    """int8 patch matrix [rows, Kp] of x (module docstring); kp defaults
    to K rounded up to a multiple of 8, rows to M."""
    if x.device.type == "cpu":
        return quantize_patches_plain(x, scale, kernel_size, stride,
                                      padding, kp, rows)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_patches runs on CUDA or CPU, not "
                         f"{x.device}")
    if x.dim() != 4 or x.dtype not in build.DTYPE_CODES:
        raise TypeError(f"quantize_patches takes a float32 or bfloat16 "
                        f"[N, C, H, W] tensor, not {x.dtype} "
                        f"{tuple(x.shape)}")
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
    x = x.contiguous()
    out = (torch.empty if rows == m else torch.zeros)(
        (rows, kp), dtype=torch.int8, device=x.device)
    lib = build.load("quant_patches", _ARGTYPES)
    with torch.cuda.device(x.device):
        status = lib.stf_quant_patches(
            x.data_ptr(), scale.data_ptr(), out.data_ptr(),
            build.DTYPE_CODES[x.dtype], n, c, h, w, *kernel_size, *stride,
            *padding, ho, wo, k, kp,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check_status("quant_patches", status)
    quantize_patches.launches += 1
    return out


quantize_patches.launches = 0
