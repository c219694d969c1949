"""The port's augmentation extras (data/transforms.py: elastic field,
photometric jitter, the per-frame re-roll mode, --data-rotation-split)
held against the JAX package on the CPU, where K2's wrapper runs its
plain version `warp_plain`.

The draws cannot match (threefry against Philox, ROADMAP.md), so each
function is compared on the same inputs and the draws by seeded
statistics.

Tolerances:
  * elastic upsampling against jax.image.resize(method="linear") of the
    same control field: atol 1e-5 (f32 bilinear weights, alpha = 8, so
    ~1e-6 relative);
  * photometric jitter against the JAX _photometric with its own factor
    draws fed to the port, no noise: atol 1e-6 on [0, 1] values (one f32
    mean over T·H·W in another order, one pow);
  * the per-frame warp against vmapped JAX _bilinear_gather /
    _nearest_gather on the same per-plane grids: targets bit-equal, images
    within 2e-5 after normalization (the port sums the taps at 0..255 and
    scales once, JAX scales to [0, 1] first: a few f32 ulps of ~10);
  * --data-rotation-split: bit-equal outputs with and without it;
  * draw statistics over thousands of draws: 5 standard errors.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from stf_unet_tpu.core.config import DataConfig as JaxDataConfig
from stf_unet_tpu.data import transforms as jax_T
from stf_unet_tpu_torch.core.config import DataConfig
from stf_unet_tpu_torch.core.prng import augment_generator
from stf_unet_tpu_torch.data import transforms as T
from stf_unet_tpu_torch.ops.kernels.warp import warp_plain

CROP = 32
SRC = 40


def _batch(seed, bsz=2, pk=False):
    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(rng.integers(0, 256, (bsz, 8, SRC, SRC),
                                           dtype=np.uint8))
    masks = torch.from_numpy(rng.integers(0, 2, (bsz, SRC, SRC),
                                          dtype=np.uint8))
    maps = (torch.from_numpy(rng.integers(0, 256, (bsz, 3, SRC, SRC),
                                          dtype=np.uint8)) if pk else None)
    sizes = torch.tensor([[SRC, SRC], [36, 38]] * (bsz // 2))
    return frames, masks, maps, sizes


@pytest.mark.parametrize("grid", [3, 4, 7])
def test_elastic_offsets_match_jax_image_resize(grid):
    field = np.random.default_rng(grid).normal(
        size=(grid, grid, 2)).astype(np.float32) * 8.0
    want = np.asarray(jax.image.resize(jnp.asarray(field), (CROP, CROP, 2),
                                       method="linear"))
    dy, dx = T.elastic_offsets(
        torch.from_numpy(field).permute(2, 0, 1)[None].contiguous(),
        torch.ones(1), CROP)
    np.testing.assert_allclose(dy[0].numpy(), want[..., 0], atol=1e-5)
    np.testing.assert_allclose(dx[0].numpy(), want[..., 1], atol=1e-5)
    off_y, _ = T.elastic_offsets(
        torch.from_numpy(field).permute(2, 0, 1)[None].contiguous(),
        torch.zeros(1), CROP)
    assert not off_y.any()  # the field's "off" draw zeroes it


@pytest.mark.parametrize("knobs", [(0.2, 0.0, 0.0), (0.0, 0.3, 0.0),
                                   (0.0, 0.0, 0.25), (0.1, 0.2, 0.3)])
def test_photometric_matches_jax_with_its_factors(knobs):
    b, c, g = knobs
    v = np.random.default_rng(1).uniform(size=(8, 24, 24)).astype(np.float32)
    jcfg = JaxDataConfig(brightness=b, contrast=c, gamma_jitter=g)
    key = jax.random.key(5)
    want = np.asarray(jax_T._photometric(key, jnp.asarray(v), jcfg))
    k = jax.random.split(key, 4)
    factors = torch.tensor([[float(jax.random.uniform(
        k[i], (), minval=1.0 - w, maxval=1.0 + w))] if w > 0 else [1.0]
        for i, w in enumerate(knobs)])
    got = T.photometric(torch.from_numpy(v)[None], factors,
                        DataConfig(brightness=b, contrast=c,
                                   gamma_jitter=g))
    np.testing.assert_allclose(got[0].numpy(), want, atol=1e-6)


def test_photometric_path_order_and_untouched_maps():
    """With photometric on, K2 only divides by 255; the jitter (frames
    only, noise from a generator seeded by the step's) and then the
    normalization follow; the PK maps are only normalized and the mask is
    the shared-frame warp's."""
    cfg = DataConfig(base_size=SRC, crop_size=CROP, brightness=0.1,
                     contrast=0.1, gamma_jitter=0.1, noise_std=0.02)
    aug = T.TrainAugment(cfg)
    assert (aug.alpha, aug.beta) == (1.0 / 255.0, 0.0)
    frames, masks, maps, sizes = _batch(2, pk=True)
    images, targets = aug(augment_generator(0, 1, 2), frames, masks, sizes,
                          maps)
    gen = augment_generator(0, 1, 2)
    gy, gx = aug.grids(gen, sizes, "cpu")
    factors, noise_gen = aug._photometric_draws(gen, 2, "cpu")
    stacked = torch.cat([frames, maps, masks.unsqueeze(1)], 1)
    bil, near = warp_plain(stacked, gy, gx, sizes.float(), 1.0 / 255.0)
    v = T.photometric(bil[:, :8], factors, cfg, noise_gen)
    want = (torch.cat([v, bil[:, 8:]], 1) - cfg.mean) / cfg.std
    assert torch.equal(images[..., 0], want)
    assert torch.equal(targets, near.long())
    plain = T.TrainAugment(DataConfig(base_size=SRC, crop_size=CROP))
    images_plain, targets_plain = plain(augment_generator(0, 1, 2), frames,
                                        masks, sizes, maps)
    # the geometry draws come first: the same targets and maps as without
    assert torch.equal(targets, targets_plain)
    np.testing.assert_allclose(images[:, 8:].numpy(),
                               images_plain[:, 8:].numpy(), atol=2e-5)


@pytest.mark.parametrize("pk", [False, True])
def test_per_frame_warp_matches_vmapped_jax_gathers(pk):
    cfg = DataConfig(base_size=SRC, crop_size=CROP,
                     shared_frame_augmentation=False)
    aug = T.TrainAugment(cfg)
    frames, masks, maps, sizes = _batch(3, pk=pk)
    images, targets = aug(augment_generator(1, 0, 0), frames, masks, sizes,
                          maps)
    p = 8 + (3 if pk else 0)
    assert images.shape == (2, p, CROP, CROP, 1)
    gy, gx = aug.grids(augment_generator(1, 0, 0), sizes, "cpu", planes=p)
    gys = gy.view(2, p, CROP, CROP).numpy()
    gxs = gx.view(2, p, CROP, CROP).numpy()
    planes = frames if maps is None else torch.cat([frames, maps], 1)
    for b in range(2):
        vh, vw = (float(v) for v in sizes[b])
        img = jnp.asarray(planes[b].numpy(), jnp.float32) / 255.0
        warped = jax.vmap(lambda fr, yy, xx: jax_T._bilinear_gather(
            fr, yy, xx, vh, vw))(img, jnp.asarray(gys[b]),
                                 jnp.asarray(gxs[b]))
        want = (np.asarray(warped) - cfg.mean) / cfg.std
        np.testing.assert_allclose(images[b, ..., 0].numpy(), want,
                                   atol=2e-5)
        tgt = jax_T._nearest_gather(jnp.asarray(masks[b].numpy(), jnp.int32),
                                    jnp.asarray(gys[b, 0]),
                                    jnp.asarray(gxs[b, 0]), vh, vw, fill=0)
        np.testing.assert_array_equal(targets[b].numpy(), np.asarray(tgt))


def test_per_frame_mode_ignores_elastic(capsys):
    aug = T.TrainAugment(DataConfig(elastic_alpha=4.0,
                                    shared_frame_augmentation=False))
    assert not aug.elastic
    assert "ignoring --data-elastic-alpha" in capsys.readouterr().out


@pytest.mark.parametrize("extras", [{}, {"elastic_alpha": 4.0,
                                         "brightness": 0.1}])
def test_rotation_split_changes_nothing(extras):
    frames, masks, maps, sizes = _batch(4, pk=True)
    out = []
    for split in (False, True):
        aug = T.TrainAugment(DataConfig(base_size=SRC, crop_size=CROP,
                                        rotation_split=split, **extras))
        out.append(aug(augment_generator(2, 3, 4), frames, masks, sizes,
                       maps))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


def test_draw_statistics():
    n = 4000
    cfg = DataConfig(base_size=SRC, crop_size=CROP, elastic_alpha=3.0,
                     elastic_grid=4, elastic_prob=0.5, brightness=0.2,
                     contrast=0.1, gamma_jitter=0.3, noise_std=0.05)
    aug = T.TrainAugment(cfg)
    gen = torch.Generator().manual_seed(0)
    sizes = torch.full((n, 2), SRC)
    gy, gx = aug.grids(gen, sizes, "cpu")
    gen = torch.Generator().manual_seed(0)
    gy0, gx0 = T.TrainAugment(DataConfig(base_size=SRC, crop_size=CROP)
                              ).grids(gen, sizes, "cpu")
    dy = (gy - gy0).view(n, -1)
    on = dy.abs().amax(1) > 0
    assert abs(on.float().mean().item() - 0.5) < 5 * 0.5 / np.sqrt(n)
    # the control grid's corners are copied to the crop's corners
    corner = dy[on][:, 0]
    n_on = int(on.sum())
    assert abs(corner.std().item() - 3.0) < 5 * 3.0 / np.sqrt(2 * n_on)
    assert abs(corner.mean().item()) < 5 * 3.0 / np.sqrt(n_on)
    factors, noise_gen = aug._photometric_draws(gen, n, "cpu")
    for row, k in zip(factors, (0.2, 0.1, 0.3)):
        assert row.min() >= 1 - k and row.max() <= 1 + k
        # U(1-k, 1+k): mean 1, sd k / sqrt(3)
        assert abs(row.mean().item() - 1) < 5 * k / np.sqrt(3 * n)
        assert abs(row.std().item() - k / np.sqrt(3)) < 0.05 * k
    v = T.photometric(torch.full((1, 8, 64, 64), 0.5),
                      torch.ones(3, 1), cfg, noise_gen)
    assert abs(v.std().item() - 0.05) < 0.002
    assert abs(v.mean().item() - 0.5) < 0.002
    # per-frame mode: the planes of a sample draw apart
    pf = T.TrainAugment(DataConfig(base_size=SRC, crop_size=CROP,
                                   shared_frame_augmentation=False))
    gy, _ = pf.grids(torch.Generator().manual_seed(1), sizes[:64], "cpu",
                     planes=8)
    gy = gy.view(64, 8, -1)
    assert (gy[:, 1:] != gy[:, :1]).any(-1).float().mean() > 0.9
