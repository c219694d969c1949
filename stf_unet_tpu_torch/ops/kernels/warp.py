"""K2: the training augmentation's fused affine warp.

Replaces the TPU kernel `stf_unet_tpu/ops/pallas/warp_kernel.py:
_pallas_warp` (kernel body `_warp_kernel`, public
`warp_bilinear_nearest_mxu`) with the hand-written CUDA kernel
`csrc/warp.cu`: a gather from each 16x16 output tile's source box staged
in shared memory (or, where the box outgrows the budget, from global
memory), not the TPU's one-hot MXU formulation. `warp_boxes` is the
kernel's tiling and box rule in plain PyTorch.

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
from typing import Optional, Tuple

import torch

from stf_unet_tpu_torch.ops.kernels import build

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
             + [ctypes.c_float] * 3 + [ctypes.c_void_p] * 2)
# csrc/warp.cu's tile edge, a staged plane's shared-memory region in bytes
# (its last 8 bytes zero) and the most planes it stages.
TILE = 16
PLANE_BYTES = 2560
MAX_PLANES = 18


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


def _clip(v: torch.Tensor, size: int) -> torch.Tensor:
    """The kernel's clip_index: NaN -> 0, then clamp to [0, size-1]."""
    v = torch.where(torch.isnan(v), torch.zeros_like(v), v)
    return v.clamp(0, size - 1).to(torch.int64)


def warp_boxes(gy: torch.Tensor, gx: torch.Tensor, h: int, w: int,
               cs: int) -> dict:
    """The kernel's tiling and box rule: for each TILE x TILE output tile
    of gy, gx [B, Ho, Wo] over a [Cs, h, w] source, the min and max of its
    pixels' clipped tap indices (floor, floor + 1 and rint, in y and x),
    the box's left edge `x0` (rounded down to 8 bytes), its row `stride`
    in bytes (the 8-byte chunks to x_hi, made odd), and whether it is
    staged: Cs <= MAX_PLANES and a plane of the box fits PLANE_BYTES less
    its 8 zero bytes. Every entry is a [B, Ho/TILE, Wo/TILE] tensor
    (tiles rounded up), int64 but `staged` (bool)."""
    bsz, ho, wo = gy.shape
    th, tw = -(-ho // TILE), -(-wo // TILE)
    out = {}
    for axis, g, size in (("y", gy, h), ("x", gx, w)):
        g = g.to(torch.float32)
        f = torch.floor(g)
        taps = torch.stack([_clip(f, size), _clip(f + 1, size),
                            _clip(torch.round(g), size)])
        pad = (0, tw * TILE - wo, 0, th * TILE - ho)
        for name, red, fill in (("lo", torch.amin, size),
                                ("hi", torch.amax, -1)):
            t = torch.nn.functional.pad(red(taps, 0), pad, value=fill)
            out[f"{axis}_{name}"] = red(
                t.view(bsz, th, TILE, tw, TILE), dim=(2, 4))
    out["x0"] = out["x_lo"] & ~7
    out["stride"] = (((out["x_hi"] >> 3) - (out["x_lo"] >> 3) + 1) | 1) * 8
    rows = out["y_hi"] - out["y_lo"] + 1
    out["staged"] = ((rows * out["stride"] <= PLANE_BYTES - 8)
                     & (cs <= MAX_PLANES))
    return out


def warp(stacked: torch.Tensor, gy: torch.Tensor, gx: torch.Tensor,
         valid: torch.Tensor, alpha: float = 1.0, beta: float = 0.0,
         fill: float = 0.0, paths: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bil [B, Cs-1, Ho, Wo], near [B, Ho, Wo]), see module docstring.
    `paths`, on CUDA only: an int64 [2] tensor on the source's device to
    which the kernel adds its blocks that took the staged ([0]) and the
    direct ([1]) path."""
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
    if paths is not None and (paths.dtype != torch.int64
                              or tuple(paths.shape) != (2,)
                              or paths.device != stacked.device
                              or not paths.is_contiguous()):
        raise ValueError(f"warp: paths must be a contiguous int64 [2] on "
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
            None if paths is None else paths.data_ptr(),
            torch.cuda.current_stream(stacked.device).cuda_stream)
    build.check_status("warp", status)
    warp.launches += 1
    return bil, near


warp.launches = 0
