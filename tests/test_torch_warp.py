"""The port's training augmentation (data/transforms.py train side, kernel
K2's plain version ops/kernels/warp.warp_plain) held against the JAX
package on the CPU: `_build_affine`, the Pallas MXU warp in interpret mode
and the XLA point-gather path `_warp_bilinear_and_nearest`.

Tolerances:
  * source coordinates from _build_affine: atol 1e-5 + rtol 1e-5 (f32
    coordinates reach ~250, where one f32 step is 1.5e-5; sin/cos may
    differ by an ulp between XLA and ATen);
  * against the MXU kernel: nearest (the labels) bit-equal; bilinear within
    0.05 on the 0..255 scale, the JAX package's own bound for that kernel
    (its bf16 hi/lo lerp weights carry ~2^-16 relative error,
    tests/test_warp_mxu.py);
  * against the point-gather path, which the plain version transcribes:
    nearest bit-equal, bilinear within 1e-4 on the 0..255 scale (the same
    f32 operations; only XLA's fusion may reassociate).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stf_unet_tpu.data import transforms as jax_T
from stf_unet_tpu.ops.pallas.warp_kernel import warp_bilinear_nearest_mxu
from stf_unet_tpu_torch.core.config import DataConfig
from stf_unet_tpu_torch.core.prng import augment_generator
from stf_unet_tpu_torch.data import transforms as T
from stf_unet_tpu_torch.ops.kernels.warp import warp, warp_plain


def _params(rng, src_h, src_w, ho, wo, max_deg=30.0):
    """Affine-family parameters as the training draws them."""
    r = rng.uniform(0.5, 1.2) * min(src_h, src_w)
    scale = r / min(src_h, src_w)
    res_h, res_w = round(src_h * scale), round(src_w * scale)
    return (np.float32(scale), np.float32(res_h), np.float32(res_w),
            bool(rng.random() < 0.5), bool(rng.random() < 0.5),
            np.float32(np.radians(rng.uniform(-max_deg, max_deg))),
            np.float32(rng.integers(0, max(int(res_h - ho), 0) + 1)),
            np.float32(rng.integers(0, max(int(res_w - wo), 0) + 1)))


def _jax_grids(params, ho, wo):
    grid_y, grid_x = jnp.meshgrid(jnp.arange(ho, dtype=jnp.float32),
                                  jnp.arange(wo, dtype=jnp.float32),
                                  indexing="ij")
    p = [jnp.bool_(v) if isinstance(v, bool) else jnp.float32(v)
         for v in params]
    gy, gx = jax_T._build_affine(*p)(grid_y, grid_x)
    return np.asarray(gy), np.asarray(gx)


def _port_grids(params, ho, wo):
    compose = T._build_affine(*params)
    gy, gx = compose(torch.arange(ho, dtype=torch.float32).view(-1, 1),
                     torch.arange(wo, dtype=torch.float32).view(1, -1))
    return gy.numpy(), gx.numpy()


@pytest.mark.parametrize("seed", range(6))
def test_build_affine_matches_jax(seed):
    rng = np.random.default_rng(seed)
    params = _params(rng, 64, 48, 32, 32)
    want = _jax_grids(params, 32, 32)
    got = _port_grids(params, 32, 32)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == (32, 32)
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)


def _batch(seed, b, c, h, w, ho, wo, valid_h, valid_w):
    rng = np.random.default_rng(seed)
    stacked = rng.integers(0, 256, (b, c + 1, h, w)).astype(np.uint8)
    stacked[:, -1] = rng.integers(0, 3, (b, h, w))  # mask channel
    gys, gxs = zip(*(_jax_grids(_params(rng, h, w, ho, wo), ho, wo)
                     for _ in range(b)))
    valid = np.stack([valid_h, valid_w], axis=-1).astype(np.int32)
    return stacked, np.stack(gys), np.stack(gxs), valid


def _port_warp(stacked, gy, gx, valid, **kw):
    bil, near = warp(torch.from_numpy(stacked), torch.from_numpy(gy),
                     torch.from_numpy(gx), torch.from_numpy(valid), **kw)
    assert bil.dtype == near.dtype == torch.float32
    return bil.numpy(), near.numpy()


def _jax_gather(stacked, gy, gx, valid, fill=0):
    def one(st, yy, xx, vh, vw):
        return jax_T._warp_bilinear_and_nearest(
            st[:-1].astype(jnp.float32), st[-1].astype(jnp.float32), yy, xx,
            vh.astype(jnp.float32), vw.astype(jnp.float32), fill=fill)
    bil, near = jax.vmap(one)(jnp.asarray(stacked), jnp.asarray(gy),
                              jnp.asarray(gx), jnp.asarray(valid[:, 0]),
                              jnp.asarray(valid[:, 1]))
    return np.asarray(bil), np.asarray(near)


CASES = {
    # full canvas valid, padded canvas, non-square valid region
    "aligned": dict(seed=3, b=3, c=4, h=64, w=64, ho=40, wo=40,
                    valid_h=[64, 50, 37], valid_w=[64, 48, 61]),
    # Ho/Wo off the TPU kernel's 8x32 tile, nonzero fill
    "ragged": dict(seed=11, b=2, c=2, h=48, w=48, ho=29, wo=35,
                   valid_h=[48, 20], valid_w=[31, 48]),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("fill", [0.0, 255.0])
def test_plain_warp_matches_mxu_kernel(case, fill):
    stacked, gy, gx, valid = _batch(**CASES[case])
    bil_ref, near_ref = warp_bilinear_nearest_mxu(
        jnp.asarray(stacked, jnp.float32), jnp.asarray(gy), jnp.asarray(gx),
        jnp.asarray(valid[:, 0]), jnp.asarray(valid[:, 1]),
        max_inv_scale=2.0, sin_bound=0.5, fill=fill, interpret=True)
    bil, near = _port_warp(stacked, gy, gx, valid, fill=fill)
    assert bil.shape == bil_ref.shape and near.shape == near_ref.shape
    np.testing.assert_array_equal(near, np.asarray(near_ref))
    np.testing.assert_allclose(bil, np.asarray(bil_ref), atol=0.05, rtol=0)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("fill", [0, 255])
def test_plain_warp_matches_point_gather(case, fill):
    stacked, gy, gx, valid = _batch(**CASES[case])
    bil_ref, near_ref = _jax_gather(stacked, gy, gx, valid, fill=fill)
    bil, near = _port_warp(stacked, gy, gx, valid, fill=float(fill))
    np.testing.assert_array_equal(near, near_ref)
    np.testing.assert_allclose(bil, bil_ref, atol=1e-4, rtol=0)


def test_nearest_rounds_half_to_even():
    """Coordinates at exact halves: the mask tap is rint(g) (2.5 -> 2,
    3.5 -> 4), as jnp.round picks it; roundf would move labels."""
    h = w = 8
    mask = np.arange(h * w, dtype=np.uint8).reshape(h, w)
    stacked = np.stack([mask, mask])[None]  # one frame, then the mask
    halves = np.array([0.5, 1.5, 2.5, 3.5, 4.5, 5.5], np.float32)
    gy = np.repeat(halves[:, None], 6, axis=1)[None]
    gx = np.repeat(halves[None, :], 6, axis=0)[None]
    valid = np.array([[h, w]], np.int32)
    _, near = _port_warp(stacked, gy, gx, valid)
    idx = np.round(halves).astype(int)  # numpy rounds half to even too
    np.testing.assert_array_equal(near[0], mask[np.ix_(idx, idx)])
    _, near_ref = _jax_gather(stacked, gy, gx, valid)
    np.testing.assert_array_equal(near, near_ref)


def test_normalization_epilogue_and_source_dtype():
    """alpha / beta fold (x/255 - mean)/std into the warp; a uint8 and a
    float32 source give the same result."""
    stacked, gy, gx, valid = _batch(**CASES["ragged"])
    cfg = DataConfig()
    aug = T.TrainAugment(cfg)
    raw, near = _port_warp(stacked, gy, gx, valid)
    got, near2 = _port_warp(stacked, gy, gx, valid, alpha=aug.alpha,
                            beta=aug.beta)
    np.testing.assert_array_equal(near, near2)
    np.testing.assert_allclose(got, (raw / 255.0 - cfg.mean) / cfg.std,
                               atol=1e-5, rtol=0)
    as_float = warp_plain(torch.from_numpy(stacked.astype(np.float32)),
                          torch.from_numpy(gy), torch.from_numpy(gx),
                          torch.from_numpy(valid))
    np.testing.assert_array_equal(as_float[0].numpy(), raw)


def test_warp_rejects_a_source_without_frames():
    z = torch.zeros((1, 1, 8, 8), dtype=torch.uint8)
    g = torch.zeros((1, 4, 4))
    with pytest.raises(ValueError, match="Cs >= 2"):
        warp(z, g, g, torch.tensor([[8, 8]]))


def test_train_augment_shapes_labels_and_determinism():
    cfg = DataConfig(base_size=48, crop_size=32)
    aug = T.TrainAugment(cfg)
    rng = np.random.default_rng(5)
    frames = torch.from_numpy(rng.integers(0, 256, (4, 3, 48, 48))
                              .astype(np.uint8))
    masks = torch.from_numpy(rng.integers(0, 2, (4, 48, 48))
                             .astype(np.uint8))
    sizes = np.array([[48, 48], [40, 48], [40, 40], [48, 44]], np.int32)
    for i, (h, w) in enumerate(sizes):  # canvas padding, outside the
        masks[i, h:] = 255              # valid region
        masks[i, :, w:] = 255
    images, targets = aug(augment_generator(0, 1, 2), frames, masks, sizes)
    assert images.shape == (4, 3, 32, 32, 1) and images.dtype == torch.float32
    assert targets.shape == (4, 32, 32) and targets.dtype == torch.int64
    assert set(np.unique(targets.numpy())) <= {0, 1}
    again = aug(augment_generator(0, 1, 2), frames, masks, sizes)
    torch.testing.assert_close(images, again[0], rtol=0, atol=0)
    torch.testing.assert_close(targets, again[1], rtol=0, atol=0)
    other = aug(augment_generator(0, 1, 3), frames, masks, sizes)
    assert not torch.equal(images, other[0])
    # the same grids through the warp's plain version give the same images
    gy, gx = aug.grids(augment_generator(0, 1, 2), sizes, frames.device)
    stacked = torch.cat([frames, masks.unsqueeze(1)], dim=1)
    bil, near = warp_plain(stacked, gy, gx, torch.from_numpy(sizes).float(),
                           alpha=aug.alpha, beta=aug.beta)
    torch.testing.assert_close(images, bil.unsqueeze(-1), rtol=0, atol=0)
    torch.testing.assert_close(targets, near.to(torch.int64), rtol=0, atol=0)


def test_sample_params_ranges():
    """Resize, crop and angle stay inside the JAX package's ranges."""
    gen = augment_generator(3, 0, 0)
    src = torch.full((4096,), 256)
    scale, res_h, res_w, hflip, vflip, angle, y0, x0 = T._sample_params(
        gen, 128, 307, 0.5, 0.5, 0.5, 30.0, 224, src, src)
    r = torch.round(scale * 256)
    assert r.min() == 128 and r.max() == 307
    assert 0.4 < hflip.float().mean() < 0.6
    assert 0.4 < (angle != 0).float().mean() < 0.6
    assert angle.abs().max() <= np.radians(30.0) + 1e-6
    assert (y0 >= 0).all() and (y0 <= torch.clamp(res_h - 224, min=0)).all()
    assert (x0 == torch.floor(x0)).all()


def test_per_frame_quirk_mode_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.TrainAugment(DataConfig(shared_frame_augmentation=False))
