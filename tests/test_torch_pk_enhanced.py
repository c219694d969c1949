"""The port's enhanced PK preprocessing and postprocessing, its AIF-method
comparison and its debug numbers (stf_unet_tpu_torch/pk/enhanced.py,
pk/debug.py, pk/fit.fit_adam_debug) held against the JAX package's
(which runs cv2 and matplotlib on this host) on the CPU, on 32^2-48^2
volumes of T = 8 frames from a numpy seed.

Tolerances:
  * the uint8 Gaussian blur of the max-projection, the Otsu threshold and
    the tissue mask: bit-equal, on every volume, the ones whose tissue
    touches the image border included;
  * the bilateral filter: within 1e-6 of cv2's (measured: 2.4e-7, two
    float32 spacings below 1; cv2's SIMD code may fuse a multiply-add);
    the normalized frames within 1e-5 of JAX's (the filter's error over
    the min-max range of each masked frame);
  * postprocess_param_maps: within 1e-6 * max |map| (the float Gaussian
    blur, float32 sums in cv2's order, up to one spacing apart);
  * the fits (LM, K4's plain version here): FIT_TOL 1e-4 on FIT_SHARE 0.99
    of the tissue voxels, tests/test_torch_pk.py's terms. Fed JAX's
    preprocessed frames, the maps are held to that share; end to end,
    from the frames, the port's own preprocessing moves the curves by the
    bilateral filter's ~1e-7 and the share is held at END_TO_END_SHARE;
  * the enhanced fits are ill-conditioned where the normalized curves are
    far from the Tofts model (the auto AIF's fast rise, or each frame
    min-max normalized on its own: ve pinned to its 0.001 floor, flat
    costs): there JAX against its own run on frames with 1e-7 of noise
    agrees on only 16-36 % of the tissue voxels at 1e-4 and on 78-100 %
    at 0.1 (measured on these volumes and on a synthetic tree's, LM 10
    and 50 iterations). Such maps (the auto AIF's here; every map of
    pk.maps --enhanced / --compare-aif in tests/test_torch_pk.py) are
    held to JAX's own spread: at each of 1e-4, 1e-2 and 0.1 the port
    keeps at least the share of voxels that the noisy JAX run keeps,
    less SPREAD_SLACK 0.05 (measured: the port always kept more); the
    AIF voxel is equal;
  * fit_adam_debug: the fit as above, the loss per epoch within 1e-5
    relative;
  * the debug numbers (the sampled voxels, the AIF position, its curve
    and the derivative map) equal to what the JAX functions hand to
    matplotlib, recorded by a stand-in pyplot.
"""

import os

import cv2
import numpy as np
import pytest

from stf_unet_tpu.core.config import PKConfig as JaxPKConfig
from stf_unet_tpu.pk import aif as jaif
from stf_unet_tpu.pk import debug as jdebug
from stf_unet_tpu.pk import enhanced as jenh
from stf_unet_tpu.pk import fit as jfit
from stf_unet_tpu.pk import tofts as jtofts
from stf_unet_tpu_torch.core.config import PKConfig
from stf_unet_tpu_torch.pk import aif as paif
from stf_unet_tpu_torch.pk import debug as pdebug
from stf_unet_tpu_torch.pk import enhanced as penh
from stf_unet_tpu_torch.pk import fit as pfit
from stf_unet_tpu_torch.pk import tofts as ptofts

FIT_TOL, FIT_SHARE = 1e-4, 0.99
END_TO_END_SHARE = 0.98
SPREAD_TOLS, SPREAD_SLACK = (1e-4, 1e-2, 1e-1), 0.05
LM = dict(lm_iters=10)


def _volume(size=48, seed=3, center=None, radius=None):
    """An enhancing disk over a dark noisy background, uint8 [8, H, W]
    (the JAX package's test volume); `center` / `radius` move it, so
    that its tissue touches the border."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    cy, cx = center or (size / 2, size / 2)
    disk = ((yy - cy) ** 2 + (xx - cx) ** 2) <= (radius or size / 3) ** 2
    frames = []
    for t in range(8):
        base = rng.uniform(0, 12, (size, size))
        signal = disk * (60 + 140 * (1 - np.exp(-0.8 * (t + 1))))
        frames.append(np.clip(base + signal, 0, 255).astype(np.uint8))
    return np.stack(frames)


def _speckled(size=40, seed=9):
    """Noisy tissue over most of the frame, reaching every border, with
    holes and islands for the morphology to close and open."""
    rng = np.random.default_rng(seed)
    level = rng.uniform(0, 1, (size, size)) > 0.35
    frames = [np.where(level, rng.integers(90, 200, (size, size)),
                       rng.integers(0, 40, (size, size))).astype(np.uint8)
              for _ in range(8)]
    return np.stack(frames)


VOLUMES = {
    "center": _volume(),
    "border": _volume(size=40, seed=4, center=(4, 30), radius=16),
    "corner": _volume(size=32, seed=5, center=(0, 0), radius=20),
    "speckled": _speckled(),
}


def _share_within(got, want, tol=FIT_TOL):
    return float((np.abs(got - want) <= tol).all(axis=1).mean())


def jax_noisy_fit(vol, cfg):
    """JAX's enhanced fit of `vol` from its own preprocessed frames plus
    1e-7 of seeded noise on the tissue: its spread on these curves."""
    frames, tissue = jenh.enhanced_preprocess(vol)
    noise = np.random.default_rng(0).normal(0, 1e-7, frames.shape)
    noisy = (frames + noise * (frames > 0)).astype(np.float32)
    exact = jenh.enhanced_preprocess
    jenh.enhanced_preprocess = lambda images, debug=None: (noisy, tissue)
    try:
        return jenh.fit_volume_enhanced(vol, cfg)
    finally:
        jenh.enhanced_preprocess = exact


def assert_within_jax_spread(got, want, spread, what=""):
    """[N, 3] maps: at each SPREAD_TOLS the port keeps the share of
    voxels within it that JAX's noisy run keeps, less SPREAD_SLACK."""
    for tol in SPREAD_TOLS:
        ours = _share_within(got, want, tol)
        theirs = _share_within(spread, want, tol)
        assert ours >= theirs - SPREAD_SLACK, (what, tol, ours, theirs)


@pytest.mark.parametrize("name", list(VOLUMES))
def test_tissue_mask_bit_equal(name):
    vol = VOLUMES[name]
    imgs = vol.astype(np.float32) / 255.0
    max_u8, mask_u8 = penh.tissue_mask_u8(imgs)
    blurred = cv2.GaussianBlur(max_u8, (5, 5), 0)
    np.testing.assert_array_equal(penh.gaussian_blur_u8(max_u8), blurred)
    level, _ = cv2.threshold(blurred, 0, 255,
                             cv2.THRESH_BINARY + cv2.THRESH_OTSU)
    assert penh.otsu_threshold(blurred) == int(level)
    _, want = jenh.enhanced_preprocess(vol)
    _, got = penh.enhanced_preprocess(vol)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(mask_u8 > 0, want)
    assert 0 < want.mean() < 1
    if name != "center":  # the tissue reaches the border
        assert want[0].any() or want[:, 0].any()


def test_morphology_and_otsu_on_hard_cases():
    """Ties in the Otsu histogram, a flat image, and masks whose open and
    close erode at the border: bit-equal to cv2."""
    rng = np.random.default_rng(0)
    kern = np.ones((5, 5), np.uint8)
    for _ in range(20):
        img = (rng.integers(0, 4, (24, 30)) * 85).astype(np.uint8)
        level, _ = cv2.threshold(img, 0, 255,
                                 cv2.THRESH_BINARY + cv2.THRESH_OTSU)
        assert penh.otsu_threshold(img) == int(level)
        m = (rng.uniform(0, 1, (24, 30)) > 0.5).astype(np.uint8) * 255
        want = cv2.morphologyEx(cv2.morphologyEx(m, cv2.MORPH_CLOSE, kern),
                                cv2.MORPH_OPEN, kern)
        np.testing.assert_array_equal(
            pfit.dilate(pfit.erode(pfit.erode(pfit.dilate(m)))), want)
    flat = np.full((16, 16), 7, np.uint8)
    assert penh.otsu_threshold(flat) == int(cv2.threshold(
        flat, 0, 255, cv2.THRESH_BINARY + cv2.THRESH_OTSU)[0])


@pytest.mark.parametrize("name", list(VOLUMES))
def test_bilateral_and_frames_within_tolerance(name):
    vol = VOLUMES[name]
    imgs = vol.astype(np.float32) / 255.0
    for t in (0, 7):
        got = penh.bilateral_filter(imgs[t])
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, cv2.bilateralFilter(imgs[t], 5, 75,
                                                            75),
                                   atol=1e-6, rtol=0)
    want, _ = jenh.enhanced_preprocess(vol)
    got, _ = penh.enhanced_preprocess(vol)
    assert got.dtype == np.float32 and got.shape == vol.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_postprocess_matches_jax():
    rng = np.random.default_rng(0)
    tissue = np.zeros((32, 36), bool)
    tissue[4:28, 2:30] = True
    maps = rng.uniform(0, 0.2, (3, 32, 36)).astype(np.float32)
    maps[1] *= 5
    want = jenh.postprocess_param_maps(maps, tissue)
    got = penh.postprocess_param_maps(maps, tissue)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    assert (got[:, ~tissue] == 0).all()
    for i in range(3):  # smoothing per se
        np.testing.assert_allclose(penh.gaussian_blur_f32(maps[i], 0.5),
                                   cv2.GaussianBlur(maps[i], (5, 5), 0.5),
                                   rtol=0, atol=1e-6 * maps[i].max())


@pytest.fixture(scope="module")
def enhanced_fits():
    vol = VOLUMES["border"]
    jax_frames, tissue = jenh.enhanced_preprocess(vol)
    want = jenh.fit_volume_enhanced(vol, JaxPKConfig(**LM))
    return vol, jax_frames, tissue, want


def test_fit_volume_enhanced_on_jax_frames(enhanced_fits, monkeypatch):
    vol, jax_frames, tissue, want = enhanced_fits
    monkeypatch.setattr(penh, "enhanced_preprocess",
                        lambda images, debug=None: (jax_frames, tissue))
    got = penh.fit_volume_enhanced(vol, PKConfig(**LM), device="cpu")
    assert got.shape == want.shape and got.dtype == np.float32
    assert tissue.sum() > 100
    assert _share_within(got[:, tissue].T, want[:, tissue].T) >= FIT_SHARE


def test_fit_volume_enhanced_end_to_end(enhanced_fits, tmp_path):
    vol, _, tissue, want = enhanced_fits
    out = str(tmp_path / "maps")
    got = penh.fit_volume_enhanced(vol, PKConfig(**LM), output_dir=out,
                                   device="cpu")
    assert np.isfinite(got).all() and (got > 0).sum() > 10
    share = _share_within(got[:, tissue].T, want[:, tissue].T)
    assert share >= END_TO_END_SHARE, share
    assert {"ktrans.png", "ve.png", "vp.png", "combined_map.png"} <= set(
        os.listdir(out))


def test_compare_aif_methods_matches_jax(tmp_path):
    vol = VOLUMES["corner"]
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    want = jenh.compare_aif_methods(vol, JaxPKConfig(**LM), jdir)
    got = penh.compare_aif_methods(vol, PKConfig(**LM), pdir, device="cpu")
    assert list(got) == list(want) == ["population", "modified", "auto"]
    frames, tissue = jenh.enhanced_preprocess(vol)
    for method in ("population", "modified"):
        assert _share_within(got[method][:, tissue].T,
                             want[method][:, tissue].T) >= FIT_SHARE, method
    for d in ("", *want):
        assert sorted(os.listdir(os.path.join(pdir, d))) == sorted(
            os.listdir(os.path.join(jdir, d))), d
    # auto: the same voxel, and held to JAX's own spread
    times = np.arange(8.0)
    assert (paif.auto_detect_aif(*penh.enhanced_preprocess(vol), times)[1]
            == jaif.auto_detect_aif(frames, tissue, times)[1])
    spread = jax_noisy_fit(vol, JaxPKConfig(aif_method="auto", **LM))
    assert_within_jax_spread(got["auto"][:, tissue].T,
                             want["auto"][:, tissue].T,
                             spread[:, tissue].T, "auto")


class _Recorder:
    """A stand-in pyplot that keeps the arrays handed to plot / imshow."""

    def __init__(self):
        self.plots, self.images = [], []

    def plot(self, *args, **kwargs):
        self.plots.append([np.asarray(a) for a in args
                           if not isinstance(a, str)])

    def imshow(self, arr, **kwargs):
        self.images.append(np.asarray(arr))

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


def _adam_case(n=60, seed=2):
    cfg = dict(solver="adam", num_epochs=20)
    jq = jtofts.ToftsQuadrature.build(JaxPKConfig().time_points,
                                      jaif.make_aif("population"), 0.01)
    pq = ptofts.ToftsQuadrature.build(PKConfig().time_points,
                                      paif.make_aif("population"), 0.01)
    rng = np.random.default_rng(seed)
    true = np.stack([rng.uniform(0.05, 0.4, n), rng.uniform(0.1, 0.5, n),
                     rng.uniform(0.01, 0.08, n)], 1).astype(np.float32)
    curves = np.asarray(jtofts.extended_tofts_batch(
        jq, true[:, 0], true[:, 1], true[:, 2]))
    return jq, pq, curves, cfg


def test_fit_adam_debug_matches_jax(monkeypatch):
    jq, pq, curves, cfg = _adam_case()
    want_fit, want_loss = jfit.fit_adam_debug(curves, jq, JaxPKConfig(**cfg))
    monkeypatch.setattr(pfit, "CHUNK", 25)  # the per-chunk sum over N
    got_fit, got_loss = pfit.fit_adam_debug(curves, pq, PKConfig(**cfg))
    assert got_loss.shape == (20,) and got_loss.dtype == np.float32
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    assert got_loss[-1] < got_loss[0]
    assert _share_within(got_fit, want_fit) >= FIT_SHARE
    empty = pfit.fit_adam_debug(curves[:0], pq, PKConfig(**cfg))
    assert empty[0].shape == (0, 3) and empty[1].shape == (20,)


def test_debug_numbers_match_what_jax_draws(monkeypatch, tmp_path):
    rec = _Recorder()
    monkeypatch.setattr(jdebug, "_plt", lambda: rec)
    # the sampled voxel curves
    jq, pq, curves, cfg = _adam_case(n=30)
    jdebug.plot_sample_time_curves(curves, range(8), str(tmp_path / "j"))
    idx = pdebug.sample_curve_indices(len(curves))
    assert len(idx) == len(rec.plots) == 10
    for j, (_, curve) in zip(idx, rec.plots):
        np.testing.assert_array_equal(curves[j], curve)
    # the Adam loss trace through fit_with_debug
    rec.plots.clear()
    jdebug.fit_with_debug(curves, jq, JaxPKConfig(**cfg), str(tmp_path))
    fitted, losses = pdebug.debug_fit(curves, pq, PKConfig(**cfg))
    np.testing.assert_allclose(losses, rec.plots[-1][0], rtol=1e-5)
    assert pdebug.debug_fit(curves, pq, PKConfig(lm_iters=3))[1] is None
    # the auto AIF: its position, curve and derivative map
    frames, tissue = jenh.enhanced_preprocess(VOLUMES["center"])
    for position in (None, (20, 27)):
        rec.plots.clear()
        rec.images.clear()
        want = jdebug.render_aif_debug(frames, tissue, range(8),
                                       str(tmp_path / "j"),
                                       position=position)
        got = pdebug.aif_debug_numbers(frames, tissue, position=position)
        assert got["position"] == want["position"]
        np.testing.assert_array_equal(got["curve"], rec.plots[0][1])
        np.testing.assert_array_equal(got["derivative_map"], rec.images[0])
        x, y = got["position"]
        ring = got["marker"] != (frames.max(axis=0) * 255).astype(np.uint8)
        rows, cols = np.nonzero(ring)
        assert ring.any() and np.hypot(rows - x, cols - y).max() <= 6.5


def test_debug_renders_need_matplotlib(monkeypatch, tmp_path):
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="--debug.*matplotlib"):
        pdebug.plot_loss_curve(np.ones(3), str(tmp_path))
    with pytest.raises(ImportError, match="--compare-aif.*matplotlib"):
        penh.compare_aif_methods(VOLUMES["corner"], PKConfig(), str(tmp_path),
                                 device="cpu")
    # the numbers need none of it
    got = pdebug.aif_debug_numbers(*penh.enhanced_preprocess(
        VOLUMES["corner"]))
    assert got["marker"].dtype == np.uint8


def test_debug_artifacts_match_jax(tmp_path):
    """fit_volume and fit_volume_enhanced with a debug directory write the
    JAX package's file set (auto AIF, Adam)."""
    from stf_unet_tpu.pk import maps as jmaps
    from stf_unet_tpu_torch.pk import maps as pmaps

    vol = VOLUMES["corner"]
    kw = dict(solver="adam", num_epochs=6, aif_method="auto")
    for fn, jfn, name in ((pmaps.fit_volume, jmaps.fit_volume, "plain"),
                          (penh.fit_volume_enhanced,
                           jenh.fit_volume_enhanced, "enhanced")):
        jd, pd = str(tmp_path / f"j_{name}"), str(tmp_path / f"p_{name}")
        jfn(vol, JaxPKConfig(**kw), debug_output_dir=jd)
        fn(vol, PKConfig(**kw), debug_output_dir=pd, device="cpu")
        assert sorted(os.listdir(pd)) == sorted(os.listdir(jd)), name
    assert "training_loss.png" in os.listdir(pd)


def test_cli_entry_points_refuse_missing_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        penh.fit_volume_enhanced(VOLUMES["corner"], PKConfig(**LM))
