"""K2: the training augmentation's fused affine warp.

Replaces the TPU kernel `stf_unet_tpu/ops/pallas/warp_kernel.py:
_pallas_warp` (kernel body `_warp_kernel`, public
`warp_bilinear_nearest_mxu`) with the hand-written CUDA kernel
`csrc/warp.cu`: a direct gather, not the TPU's one-hot MXU formulation.

stacked [B, Cs, H, W] (values 0..255; the frames, then the mask last),
gy / gx [B, Ho, Wo] f32 source coordinates, valid [B, 2] (valid_h,
valid_w) -> (bil [B, Cs-1, Ho, Wo] f32 = bilinear * alpha + beta,
near [B, Ho, Wo] f32 = the mask at the half-to-even rounded coordinate,
`fill` outside the valid region). The arithmetic is the JAX package's
point-gather path (data/transforms.py:_warp_bilinear_and_nearest).

Bound on the H100: bytes (~45 MB at B=16, Cs=9, 256^2 -> 224^2: ~13 us at
3.35 TB/s); its measured times are in PERF.md.

On a CPU tensor the wrapper runs `warp_plain`; on a CUDA tensor it
launches the kernel (which reads the source as uint8) or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from stf_unet_tpu_torch.ops.kernels import build

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
             + [ctypes.c_float] * 3 + [ctypes.c_void_p])


def _check(stacked: torch.Tensor, gy: torch.Tensor, gx: torch.Tensor,
           valid: torch.Tensor) -> None:
    if stacked.dim() != 4 or stacked.shape[1] < 2:
        raise ValueError(f"warp: stacked must be [B, Cs, H, W] with Cs >= 2 "
                         f"(frames, then the mask); got "
                         f"{tuple(stacked.shape)}")
    bsz = stacked.shape[0]
    if gy.dim() != 3 or gy.shape != gx.shape or gy.shape[0] != bsz:
        raise ValueError(f"warp: gy, gx must both be [B={bsz}, Ho, Wo]; got "
                         f"{tuple(gy.shape)} and {tuple(gx.shape)}")
    if tuple(valid.shape) != (bsz, 2):
        raise ValueError(f"warp: valid must be [{bsz}, 2]; got "
                         f"{tuple(valid.shape)}")


def warp_plain(stacked: torch.Tensor, gy: torch.Tensor, gx: torch.Tensor,
               valid: torch.Tensor, alpha: float = 1.0, beta: float = 0.0,
               fill: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: four clipped point gathers
    with out-of-valid taps zeroed, the bilinear sum in the JAX package's
    order, and the nearest tap at torch.round (half to even)."""
    _check(stacked, gy, gx, valid)
    bsz, cs, h, w = stacked.shape
    ho, wo = gy.shape[1:]
    f32 = torch.float32
    flat = stacked.reshape(bsz, cs, h * w).to(f32)
    gy, gx = gy.to(f32), gx.to(f32)
    vh = valid[:, 0].to(f32).view(bsz, 1, 1)
    vw = valid[:, 1].to(f32).view(bsz, 1, 1)

    def gather(yy, xx, channels):
        inside = (yy >= 0) & (yy <= vh - 1) & (xx >= 0) & (xx <= vw - 1)
        yc = yy.clamp(0, h - 1).to(torch.int64)
        xc = xx.clamp(0, w - 1).to(torch.int64)
        idx = (yc * w + xc).view(bsz, 1, ho * wo).expand(bsz, channels, -1)
        vals = flat[:, :channels] if channels < cs else flat
        vals = vals.gather(2, idx).view(bsz, channels, ho, wo)
        return vals, inside.unsqueeze(1)

    y0, x0 = torch.floor(gy), torch.floor(gx)
    wy = (gy - y0).unsqueeze(1)
    wx = (gx - x0).unsqueeze(1)
    taps = []
    for yy, xx in ((y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1)):
        vals, inside = gather(yy, xx, cs - 1)
        taps.append(vals * inside.to(f32))
    v00, v01, v10, v11 = taps
    bil = (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
           + v10 * wy * (1 - wx) + v11 * wy * wx)
    bil = bil * alpha + beta

    ry, rx = torch.round(gy), torch.round(gx)
    inside = (ry >= 0) & (ry <= vh - 1) & (rx >= 0) & (rx <= vw - 1)
    yc = ry.clamp(0, h - 1).to(torch.int64)
    xc = rx.clamp(0, w - 1).to(torch.int64)
    mask = flat[:, cs - 1]
    near = mask.gather(1, (yc * w + xc).view(bsz, ho * wo)).view(bsz, ho, wo)
    near = torch.where(inside, near, torch.full_like(near, fill))
    return bil, near


def warp(stacked: torch.Tensor, gy: torch.Tensor, gx: torch.Tensor,
         valid: torch.Tensor, alpha: float = 1.0, beta: float = 0.0,
         fill: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bil [B, Cs-1, Ho, Wo], near [B, Ho, Wo]), see module docstring."""
    if stacked.device.type == "cpu":
        return warp_plain(stacked, gy, gx, valid, alpha, beta, fill)
    if stacked.device.type != "cuda":
        raise ValueError(f"warp runs on CUDA or CPU, not {stacked.device}")
    _check(stacked, gy, gx, valid)
    if stacked.dtype != torch.uint8:
        raise TypeError(f"the warp kernel reads a uint8 source; got "
                        f"{stacked.dtype}")
    for name, v in (("gy", gy), ("gx", gx), ("valid", valid)):
        if v.device != stacked.device:
            raise ValueError(f"warp: {name} is on {v.device}, the source on "
                             f"{stacked.device}")
    bsz, cs, h, w = stacked.shape
    ho, wo = gy.shape[1:]
    lib = build.load("warp", _ARGTYPES)
    stacked = stacked.contiguous()
    gy = gy.to(torch.float32).contiguous()
    gx = gx.to(torch.float32).contiguous()
    valid = valid.to(torch.float32).contiguous()
    bil = torch.empty((bsz, cs - 1, ho, wo), dtype=torch.float32,
                      device=stacked.device)
    near = torch.empty((bsz, ho, wo), dtype=torch.float32,
                       device=stacked.device)
    with torch.cuda.device(stacked.device):
        status = lib.stf_warp(
            stacked.data_ptr(), gy.data_ptr(), gx.data_ptr(),
            valid.data_ptr(), bil.data_ptr(), near.data_ptr(), bsz, cs, h, w,
            ho, wo, float(alpha), float(beta), float(fill),
            torch.cuda.current_stream(stacked.device).cuda_stream)
    build.check_status("warp", status)
    warp.launches += 1
    return bil, near


warp.launches = 0
