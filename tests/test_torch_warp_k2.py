"""K2's tiling and box rule (ops/kernels/warp.warp_boxes, the emulation of
csrc/warp.cu's 16x16 tiles) on the CPU: the training augmentation's
extreme draws take the staged path with every tap inside the box, scattered
and far-off coordinates take the direct path, a gather through the staged
boxes' relative indices gives warp_plain's output bit for bit, and
warp_plain stays within the existing tolerances of the interpret-mode
Pallas warp (nearest equal, bilinear 0.05 on the 0..255 scale,
tests/test_torch_warp.py) on a draw that the kernel stages.
"""

import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stf_unet_tpu.ops.pallas.warp_kernel import warp_bilinear_nearest_mxu
from stf_unet_tpu_torch.core.config import DataConfig
from stf_unet_tpu_torch.data import transforms as T
from stf_unet_tpu_torch.ops.kernels.warp import (PLANE_BYTES, TILE,
                                                 warp_boxes, warp_plain)

CANVAS = 256


def _extreme_grids(crop: int):
    """gy, gx [N, crop, crop] of every extreme training draw on a 256^2
    canvas: valid region 256x256 or 240x224, short edge resized to the
    config's min and max, angle 0 and +-30 degrees, all four flips, crop
    offsets at both ends."""
    aug = T.TrainAugment(DataConfig(crop_size=crop))
    deg = aug.cfg.rotate_degrees
    rows = []
    for (sh, sw), r, angle, hf, vf, ey, ex in itertools.product(
            ((CANVAS, CANVAS), (240, 224)), (aug.min_size, aug.max_size),
            (0.0, -deg, deg), (False, True), (False, True), (0, 1), (0, 1)):
        scale = r / min(sh, sw)
        res_h, res_w = round(sh * scale), round(sw * scale)
        y0 = ey * max(res_h - crop, 0)
        x0 = ex * max(res_w - crop, 0)
        rows.append((scale, res_h, res_w, hf, vf, math.radians(angle), y0,
                     x0))
    params = [torch.tensor([row[i] for row in rows]).view(-1, 1, 1)
              for i in range(8)]
    line = torch.arange(crop, dtype=torch.float32)
    return T._build_affine(*params)(line.view(-1, 1), line.view(1, -1))


def _tile_of(boxes: dict, key: str, ho: int, wo: int) -> torch.Tensor:
    """boxes[key] [B, Ho/TILE, Wo/TILE] spread to each pixel [B, Ho, Wo]."""
    v = boxes[key].repeat_interleave(TILE, 1).repeat_interleave(TILE, 2)
    return v[:, :ho, :wo]


def _taps(g: torch.Tensor, size: int):
    f = torch.floor(g)
    return [torch.nan_to_num(t, nan=0.0).clamp(0, size - 1).long()
            for t in (f, f + 1, torch.round(g))]


@pytest.mark.parametrize("crop", [224, 200])
@pytest.mark.parametrize("cs", [9, 12])
def test_extreme_training_draws_are_staged(cs, crop):
    gy, gx = _extreme_grids(crop)
    boxes = warp_boxes(gy, gx, CANVAS, CANVAS, cs)
    assert bool(boxes["staged"].all())
    for axis, g in (("y", gy), ("x", gx)):
        lo = _tile_of(boxes, f"{axis}_lo", crop, crop)
        hi = _tile_of(boxes, f"{axis}_hi", crop, crop)
        for t in _taps(g, CANVAS):
            assert bool(((t >= lo) & (t <= hi)).all())
    x0, stride = boxes["x0"], boxes["stride"]
    assert bool((x0 % 8 == 0).all() and (stride % 16 == 8).all())
    assert bool((boxes["x_hi"] < x0 + stride).all())
    rows = boxes["y_hi"] - boxes["y_lo"] + 1
    assert int((rows * stride).max()) <= PLANE_BYTES - 8


@pytest.mark.parametrize("lo,hi", [(-0.5, CANVAS - 0.5), (-1e4, 1e4)],
                         ids=["scattered", "far_off_both_sides"])
def test_scattered_coordinates_take_the_direct_path(lo, hi):
    rng = np.random.default_rng(5)
    gy, gx = (torch.from_numpy(rng.uniform(lo, hi, (2, 40, 40))
                               .astype(np.float32)) for _ in range(2))
    boxes = warp_boxes(gy, gx, CANVAS, CANVAS, 9)
    assert not bool(boxes["staged"].any())


def _staged_gather(stacked, gy, gx, valid, alpha, beta, fill):
    """bil, near gathered as the kernel's staged path gathers them: each
    tile's box copied into a PLANE_BYTES region a plane, [row, stride
    bytes] (whole 8-byte chunks inside the row), the region's last 8 bytes
    zero and every byte the copy does not write NaN; every tap read at its
    box-relative offset, a bilinear tap outside the valid region at the
    zero byte, the mask tap selected against `fill`."""
    bsz, cs, h, w = stacked.shape
    ho, wo = gy.shape[1:]
    boxes = warp_boxes(gy, gx, h, w, cs)
    assert bool(boxes["staged"].all())
    src = stacked.to(torch.float32)
    ty, tx = boxes["y_lo"].shape[1:]
    vals = torch.empty((bsz, cs, 5, ho, wo))   # taps 00, 01, 10, 11, near
    ys, xs = _taps(gy, h), _taps(gx, w)
    vh = valid[:, 0].view(bsz, 1, 1)
    vw = valid[:, 1].view(bsz, 1, 1)
    y0, x0 = torch.floor(gy), torch.floor(gx)
    ry, rx = torch.round(gy), torch.round(gx)
    inside = [(yy >= 0) & (yy <= vh - 1) & (xx >= 0) & (xx <= vw - 1)
              for yy, xx in ((y0, x0), (y0, x0 + 1), (y0 + 1, x0),
                             (y0 + 1, x0 + 1), (ry, rx))]
    for b, i, j in itertools.product(range(bsz), range(ty), range(tx)):
        y_lo, y_hi, x_hi, xb, stride = (
            int(boxes[k][b, i, j]) for k in ("y_lo", "y_hi", "x_hi", "x0",
                                             "stride"))
        rows = y_hi - y_lo + 1
        region = torch.full((cs, PLANE_BYTES), float("nan"))
        region[:, -8:] = 0
        box = region[:, :rows * stride].view(cs, rows, stride)
        x1 = min(xb + (x_hi // 8 - xb // 8 + 1) * 8, w)
        box[:, :, :x1 - xb] = src[b, :, y_lo:y_hi + 1, xb:x1]
        sl = (slice(i * TILE, (i + 1) * TILE), slice(j * TILE, (j + 1) * TILE))
        for k, (yy, xx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1),
                                      (2, 2))):
            rel = (ys[yy][b][sl] - y_lo) * stride + (xs[xx][b][sl] - xb)
            if k < 4:
                rel = torch.where(inside[k][b][sl], rel, PLANE_BYTES - 1)
            vals[b, :, k][(slice(None),) + sl] = region[:, rel.reshape(-1)
                                                        ].view(cs, *rel.shape)
    v00, v01, v10, v11 = (vals[:, :cs - 1, k] for k in range(4))
    wy = (gy - y0).unsqueeze(1)
    wx = (gx - x0).unsqueeze(1)
    bil = (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
           + v10 * wy * (1 - wx) + v11 * wy * wx)
    bil = bil * alpha + beta
    near = torch.where(inside[4], vals[:, cs - 1, 4],
                       torch.full_like(ry, fill))
    return bil, near


def _draw(seed, h, w, ho, wo, cs, scale=None):
    """A training-style batch: random planes and a 0..2 mask, per-sample
    affine grids (TrainAugment's family), valid regions below the canvas."""
    rng = np.random.default_rng(seed)
    bsz = 2
    stacked = rng.integers(0, 256, (bsz, cs, h, w)).astype(np.uint8)
    stacked[:, -1] = rng.integers(0, 3, (bsz, h, w))
    sizes = np.array([[h, w], [h - 5, w - 9]], np.float32)
    grids = []
    for sh, sw in sizes:
        s = scale if scale is not None else rng.uniform(0.5, 1.2)
        res_h, res_w = round(sh * s), round(sw * s)
        params = (s, res_h, res_w, bool(rng.random() < 0.5),
                  bool(rng.random() < 0.5),
                  math.radians(rng.uniform(-30, 30)),
                  float(rng.integers(0, max(res_h - ho, 0) + 1)),
                  float(rng.integers(0, max(res_w - wo, 0) + 1)))
        compose = T._build_affine(*params)
        grids.append(compose(torch.arange(ho, dtype=torch.float32).view(-1, 1),
                             torch.arange(wo, dtype=torch.float32).view(1, -1)))
    gy = torch.stack([g[0] for g in grids])
    gx = torch.stack([g[1] for g in grids])
    return torch.from_numpy(stacked), gy, gx, torch.from_numpy(sizes)


@pytest.mark.parametrize("w", [64, 62], ids=["w_words", "w_ragged"])
@pytest.mark.parametrize("seed,cs", [(0, 5), (1, 9), (2, 12)])
def test_staged_gather_matches_plain_bit_for_bit(seed, cs, w):
    stacked, gy, gx, valid = _draw(seed, 64, w, 40, 37, cs=cs)
    alpha, beta, fill = 1 / (255 * 0.127), -0.709 / 0.127, 3.0
    got = _staged_gather(stacked, gy, gx, valid, alpha, beta, fill)
    want = warp_plain(stacked, gy, gx, valid, alpha, beta, fill)
    for g, ref in zip(got, want):
        assert torch.equal(g, ref)


def test_far_off_one_side_is_staged_and_exact():
    """Coordinates all beyond one corner clip to one canvas pixel: a
    one-row box, staged, and the gather through it still matches the
    twin."""
    stacked, gy, gx, valid = _draw(7, 32, 32, 20, 20, cs=3)
    gy, gx = gy + 1e4, gx - 1e4
    assert bool(warp_boxes(gy, gx, 32, 32, 3)["staged"].all())
    got = _staged_gather(stacked, gy, gx, valid, 1.0, 0.0, 2.0)
    want = warp_plain(stacked, gy, gx, valid, 1.0, 0.0, 2.0)
    for g, ref in zip(got, want):
        assert torch.equal(g, ref)


@pytest.mark.parametrize("scale", [0.5, 1.2])
def test_plain_matches_mxu_kernel_on_a_staged_draw(scale):
    stacked, gy, gx, valid = _draw(11, 64, 64, 40, 40, cs=4, scale=scale)
    assert bool(warp_boxes(gy, gx, 64, 64, 4)["staged"].all())
    bil_ref, near_ref = warp_bilinear_nearest_mxu(
        jnp.asarray(stacked.numpy(), jnp.float32), jnp.asarray(gy.numpy()),
        jnp.asarray(gx.numpy()), jnp.asarray(valid[:, 0].numpy()),
        jnp.asarray(valid[:, 1].numpy()), max_inv_scale=2.0, sin_bound=0.5,
        interpret=True)
    bil, near = warp_plain(stacked, gy, gx, valid)
    np.testing.assert_array_equal(near.numpy(), np.asarray(near_ref))
    np.testing.assert_allclose(bil.numpy(), np.asarray(bil_ref), atol=0.05,
                               rtol=0)
