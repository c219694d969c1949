"""The port's PK modules (stf_unet_tpu_torch/pk/, kernel K4's plain
version ops/kernels/tofts.tofts_sums_plain) held against the JAX package's
stf_unet_tpu/pk/ on the CPU, on the same numpy inputs.

Tolerances:
  * quadrature: the grid (lags, the time points, the mask) bit-equal;
    weights and Cp(t) within 2.4e-7 relative (two f32 spacings): XLA's and
    ATen's float32 exp differ in the last bit on ~10 % of arguments, and
    the weights are dt * Cp(tau). Given JAX's Cp values the port's weights
    are bit-equal. The auto AIF (interpolation, no exp) within 1e-6
    relative;
  * K4's plain version against `_dual_sums` "xla" and "pallas_interpret":
    rtol 1e-5, atol 1e-6, the JAX package's own kernel-vs-XLA limits
    (the same f32 terms summed over Q=700 in another order);
  * Jacobian: rtol 1e-5, atol 1e-6 * max |value| (the sums above);
  * _solve3x3: the same Cramer formula in f32, within 1e-5 * max |x|
    (damped systems with lambda down to 1e-8 cancel a few digits);
  * mask and preprocessing: bit-equal;
  * solvers on N=300 curves: at least 99 % of voxels within 1e-4 on every
    parameter. Both LM runs branch on `cost_cand < cost_p`; with noise a
    near tie flips on a few unconverged voxels (measured: 0.7 % of
    voxels, up to 1.8e-4), so the share, not the maximum, is held.
"""

import os
import shutil

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from stf_unet_tpu.core.config import PKConfig as JaxPKConfig
from stf_unet_tpu.data.index import DatasetIndex as JaxIndex
from stf_unet_tpu.data.loader import load_sample_raw as jax_load_sample_raw
from stf_unet_tpu.pk import aif as jaif
from stf_unet_tpu.pk import fit as jfit
from stf_unet_tpu.pk import maps as jmaps
from stf_unet_tpu.pk import tofts as jtofts
from stf_unet_tpu_torch.core.config import PKConfig
from stf_unet_tpu_torch.data.index import DatasetIndex
from stf_unet_tpu_torch.data.loader import load_sample_raw
from stf_unet_tpu_torch.data.synthetic import make_synthetic_breadm
from stf_unet_tpu_torch.ops.kernels.tofts import tofts_sums, tofts_sums_plain
from stf_unet_tpu_torch.pk import aif as paif
from stf_unet_tpu_torch.pk import fit as pfit
from stf_unet_tpu_torch.pk import maps as pmaps
from stf_unet_tpu_torch.pk import tofts as ptofts

T_POINTS = np.arange(8, dtype=np.float32)
SEQS = tuple(f"SUB{i}" for i in range(1, 9))
FIT_TOL, FIT_SHARE = 1e-4, 0.99


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's small CPU steps: the test
    workers share the host's cores, and torch's default of a thread per
    core makes each tiny op of one worker wait on the others'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _auto_images(seed=0):
    """[8, 16, 16] curves in [0, 1] with one steep voxel, and a mask."""
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 0.3, (8, 16, 16)).astype(np.float32)
    imgs[:, 5, 9] = [0.05, 0.9, 0.7, 0.6, 0.55, 0.5, 0.45, 0.4]
    return imgs, np.ones((16, 16), bool)


def _aifs(method):
    """(JAX AIF, port AIF) for one method; auto from the same images."""
    if method != "auto":
        return jaif.make_aif(method), paif.make_aif(method)
    imgs, mask = _auto_images()
    jfn, jpos = jaif.auto_detect_aif(imgs, mask, T_POINTS)
    pfn, ppos = paif.auto_detect_aif(imgs, mask, T_POINTS)
    assert jpos == ppos == (5, 9)
    return jfn, pfn


def _port_quad_of(jq):
    """The port's quadrature holding exactly JAX's tables."""
    lags, weights = (torch.from_numpy(np.array(a))
                     for a in (jq.lags, jq.weights))
    return ptofts.ToftsQuadrature(
        time_points=torch.from_numpy(np.array(jq.time_points)),
        aif_at_t=torch.from_numpy(np.array(jq.aif_at_t)), weights=weights,
        lags=lags, wlags=weights * lags)


@pytest.mark.parametrize("method", ["population", "modified", "auto"])
def test_quadrature_matches_jax(method):
    jfn, pfn = _aifs(method)
    jq = jtofts.ToftsQuadrature.build(T_POINTS, jfn)
    pq = ptofts.ToftsQuadrature.build(T_POINTS, pfn)
    assert pq.lags.shape == (8, 700) and pq.lags.dtype == torch.float32
    np.testing.assert_array_equal(pq.lags.numpy(), np.asarray(jq.lags))
    np.testing.assert_array_equal(pq.time_points.numpy(),
                                  np.asarray(jq.time_points))
    np.testing.assert_array_equal(pq.weights.numpy() == 0,
                                  np.asarray(jq.weights) == 0)
    rtol = 1e-6 if method == "auto" else 2.4e-7
    np.testing.assert_allclose(pq.weights.numpy(), np.asarray(jq.weights),
                               rtol=rtol, atol=0)
    np.testing.assert_allclose(pq.aif_at_t.numpy(), np.asarray(jq.aif_at_t),
                               rtol=rtol, atol=0)
    np.testing.assert_array_equal(pq.wlags.numpy(),
                                  (pq.weights * pq.lags).numpy())
    # given JAX's Cp values, the port builds the same tables bit for bit
    same = ptofts.ToftsQuadrature.build(
        T_POINTS, lambda t: torch.from_numpy(np.array(jfn(jnp.asarray(
            t.numpy())))))
    np.testing.assert_array_equal(same.weights.numpy(),
                                  np.asarray(jq.weights))
    np.testing.assert_array_equal(same.aif_at_t.numpy(),
                                  np.asarray(jq.aif_at_t))


def test_auto_aif_extrapolates_like_jax():
    jfn, pfn = _aifs("auto")
    t = np.array([-1.5, 0.0, 0.25, 3.5, 6.999, 7.0, 8.5, 12.0], np.float32)
    np.testing.assert_allclose(pfn(torch.from_numpy(t)).numpy(),
                               np.asarray(jfn(jnp.asarray(t))),
                               rtol=1e-6, atol=0)
    # 'auto' without a detected curve falls back to 'modified' (ref:85-87)
    assert paif.make_aif("auto") is paif.modified_aif
    with pytest.raises(ValueError):
        paif.make_aif("nope")


def _rates(n, seed):
    """Rates K/ve over [0, 1000]: log-uniform and uniform halves, one 0."""
    rng = np.random.default_rng(seed)
    rate = np.concatenate([10.0 ** rng.uniform(-3, 3, n // 2),
                           rng.uniform(0, 1000, n - n // 2)])
    rate[0] = 0.0
    return rng.permutation(rate).astype(np.float32)


@pytest.mark.parametrize("method", ["population", "auto"])
@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("n", [100, 1000])
def test_tofts_sums_plain_matches_jax(method, backend, n):
    """N=1000 is ragged against the TPU kernel's 512-voxel tiles; the auto
    AIF's curve makes some weights negative, so the sums may cancel."""
    jfn, _ = _aifs(method)
    jq = jtofts.ToftsQuadrature.build(T_POINTS, jfn)
    rate = _rates(n, seed=n)
    want = jtofts._dual_sums(jq, jnp.asarray(rate), backend)
    pq = _port_quad_of(jq)
    before = tofts_sums.launches
    got = ptofts.dual_sums(pq, torch.from_numpy(rate))  # "auto" on the CPU
    plain = tofts_sums_plain(torch.from_numpy(rate), pq.lags, pq.weights,
                             pq.wlags)
    assert tofts_sums.launches == before  # the CPU runs no kernel
    for g, p, w in zip(got, plain, want):
        assert g.shape == (n, 8) and g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), p.numpy())
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


def test_tofts_sums_checks_its_inputs():
    lags = torch.zeros((8, 700))
    with pytest.raises(ValueError, match="rate must be"):
        tofts_sums(torch.zeros((4, 1)), lags, lags, lags)
    with pytest.raises(ValueError, match="weights"):
        tofts_sums(torch.zeros(4), lags, torch.zeros((8, 699)), lags)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tofts_sums(torch.zeros(4, device="meta"), lags, lags, lags)
    with pytest.raises(ValueError, match="backend"):
        ptofts.dual_sums(_port_quad_of(jtofts.ToftsQuadrature.build(
            T_POINTS, jaif.make_aif("population"))), torch.zeros(4), "xla")


def _params(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0.02, 0.5, n), rng.uniform(0.05, 0.4, n),
                     rng.uniform(0.0, 0.15, n)], axis=1).astype(np.float32)


def test_jacobian_matches_jax_and_autograd():
    jq = jtofts.ToftsQuadrature.build(T_POINTS, jaif.make_aif("population"))
    pq = _port_quad_of(jq)
    p = _params(64, 5)
    jc, jjac = jtofts.extended_tofts_with_jacobian(
        jq, *(jnp.asarray(p[:, i]) for i in range(3)), backend="xla")
    pt = torch.from_numpy(p)
    c, jac = ptofts.extended_tofts_with_jacobian(pq, pt[:, 0], pt[:, 1],
                                                 pt[:, 2])
    assert jac.shape == (64, 8, 3)
    for got, want in ((c, jc), (jac, jjac)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
    # the analytic Jacobian is the derivative of the plain forward
    fwd = ptofts.extended_tofts_batch(pq, pt[:, 0], pt[:, 1], pt[:, 2])
    torch.testing.assert_close(c, fwd, rtol=1e-5, atol=1e-6)
    full = torch.autograd.functional.jacobian(
        lambda q: ptofts.extended_tofts_batch(pq, q[:, 0], q[:, 1], q[:, 2]),
        pt)                                               # [N, T, N, 3]
    diag = full[torch.arange(64), :, torch.arange(64), :]
    torch.testing.assert_close(jac, diag, rtol=1e-4, atol=1e-5)


def test_solve3x3_matches_jax_and_lapack():
    rng = np.random.default_rng(0)
    jac = rng.normal(size=(64, 8, 3)).astype(np.float32)
    a = np.einsum("nti,ntj->nij", jac, jac)
    lams = np.logspace(-8, 2, 64).astype(np.float32)
    a = a + lams[:, None, None] * np.eye(3, dtype=np.float32)
    b = rng.normal(size=(64, 3)).astype(np.float32)
    got = pfit._solve3x3(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jfit._solve3x3(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    exact = np.linalg.solve(a.astype(np.float64),
                            b.astype(np.float64)[..., None])[..., 0]
    np.testing.assert_allclose(got, exact, rtol=2e-2, atol=2e-4)


def test_tissue_mask_and_preprocess_bit_equal():
    rng = np.random.default_rng(4)
    mask = rng.uniform(size=(40, 40)) > 0.6
    np.testing.assert_array_equal(pfit.tissue_mask_morphology(mask),
                                  jfit.tissue_mask_morphology(mask))
    imgs = rng.integers(0, 255, (8, 32, 32)).astype(np.uint8)
    imgs[:, :8, :8] = 0  # a dark corner below the threshold
    for images in (imgs, imgs.astype(np.float32) / 255.0):
        want_imgs, want_mask = jfit.preprocess_images(images, JaxPKConfig())
        got_imgs, got_mask = pfit.preprocess_images(images, PKConfig())
        assert got_imgs.dtype == torch.float32 and got_mask.dtype == torch.bool
        np.testing.assert_array_equal(got_imgs.numpy(), np.asarray(want_imgs))
        np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    assert not got_mask[:6, :6].any()


def _curves(n=300, noise=0.0, seed=11):
    jq = jtofts.ToftsQuadrature.build(T_POINTS, jaif.make_aif("population"))
    rng = np.random.default_rng(seed)
    true = np.stack([rng.uniform(0.02, 0.4, n), rng.uniform(0.1, 0.4, n),
                     rng.uniform(0.01, 0.09, n)], axis=1).astype(np.float32)
    curves = np.asarray(jtofts.extended_tofts_batch(
        jq, *(jnp.asarray(true[:, i]) for i in range(3))))
    if noise:
        curves = curves + rng.normal(0, noise, curves.shape).astype(
            np.float32)
    return jq, curves


def _share_within(got, want, tol=FIT_TOL):
    return float((np.abs(got - want) <= tol).all(axis=1).mean())


@pytest.mark.parametrize("solver", ["lm", "adam"])
@pytest.mark.parametrize("noise", [0.0, 1e-3])
def test_solvers_match_jax(solver, noise):
    jq, curves = _curves(noise=noise)
    kw = dict(lm_iters=20, num_epochs=50)
    jfn = jfit.fit_lm if solver == "lm" else jfit.fit_adam
    pfn = pfit.fit_lm if solver == "lm" else pfit.fit_adam
    want = jfn(curves, jq, JaxPKConfig(**kw))
    got = pfn(curves, _port_quad_of(jq), PKConfig(**kw))
    assert got.shape == (300, 3) and got.dtype == np.float32
    assert _share_within(got, want) >= FIT_SHARE


@pytest.mark.parametrize("solver", ["lm", "adam"])
def test_synthetic_parameter_recovery(solver):
    """The JAX package's recovery check (tests/test_pk.py), on the port."""
    cfg = PKConfig(solver=solver, num_epochs=300, lm_iters=60)
    quad = ptofts.ToftsQuadrature.build(cfg.time_points,
                                        paif.make_aif("population"), cfg.dt)
    true = torch.tensor([[0.12, 0.25, 0.04], [0.30, 0.15, 0.02],
                         [0.05, 0.35, 0.08]])
    curves = ptofts.extended_tofts_batch(quad, true[:, 0], true[:, 1],
                                         true[:, 2]).numpy()
    fit = pfit.fit_lm if solver == "lm" else pfit.fit_adam
    est = fit(curves, quad, cfg)
    np.testing.assert_allclose(est, true.numpy(),
                               atol=0.02 if solver == "lm" else 0.08)


def test_lm_chunks_and_clamp_box(monkeypatch):
    """Chunking changes nothing (voxels are independent); absurd curves
    stay inside the physiological box."""
    jq, curves = _curves(n=50, noise=1e-3)
    pq = _port_quad_of(jq)
    cfg = PKConfig(lm_iters=10)
    whole = pfit.fit_lm(curves, pq, cfg)
    monkeypatch.setattr(pfit, "CHUNK", 16)
    np.testing.assert_array_equal(pfit.fit_lm(curves, pq, cfg), whole)
    assert pfit.fit_lm(np.zeros((0, 8), np.float32), pq, cfg).shape == (0, 3)
    est = pfit.fit_lm(np.full((8, 8), 50.0, np.float32), pq, cfg)
    lo, hi = (np.array([cfg.ktrans_bounds[i], cfg.ve_bounds[i],
                        cfg.vp_bounds[i]], np.float32) for i in (0, 1))
    assert (est >= lo).all() and (est <= hi).all()


@pytest.fixture(scope="module")
def sub_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("pk_tree")
    return make_synthetic_breadm(str(root / "b"), size=32, time_steps=8,
                                 patients_per_split=2, slices_per_patient=1,
                                 sequence_prefix="SUB", seed=5)


def test_fit_volume_matches_jax(sub_tree):
    path = os.path.join(sub_tree, "seg", "training", "images", "P000")
    frames = pmaps._load_patient_frames(path)
    np.testing.assert_array_equal(frames, jmaps._load_patient_frames(path))
    assert frames.shape == (8, 32, 32) and frames.dtype == np.uint8
    kw = dict(lm_iters=10)
    want = jmaps.fit_volume(frames, JaxPKConfig(**kw))
    got = pmaps.fit_volume(frames, PKConfig(**kw), device="cpu")
    assert got.shape == (3, 32, 32) and got.dtype == np.float32
    np.testing.assert_array_equal(got != 0, want != 0)  # the same mask
    tissue = np.asarray(jfit.preprocess_images(frames, JaxPKConfig())[1])
    assert tissue.sum() > 10
    assert _share_within(got[:, tissue].T, want[:, tissue].T) >= FIT_SHARE
    # a volume with missing sequences fits over the frames it has
    short = pmaps.fit_volume(frames[:6], PKConfig(**kw), device="cpu")
    assert short.shape == (3, 32, 32) and np.isfinite(short).all()


def test_generate_pk_maps_matches_jax_and_loads(sub_tree, tmp_path):
    jax_root = str(tmp_path / "jax")
    shutil.copytree(sub_tree, jax_root)
    out = pmaps.generate_pk_maps_for_dataset(
        sub_tree, splits=["training"], cfg=PKConfig(lm_iters=10),
        device="cpu")
    jmaps.generate_pk_maps_for_dataset(jax_root, splits=["training"],
                                       cfg=JaxPKConfig(lm_iters=10))
    assert out == {"training": os.path.join(sub_tree, "seg", "training",
                                            "pk_maps")}
    for patient in ("P000", "P001"):
        got_dir = os.path.join(out["training"], patient)
        want_dir = os.path.join(jax_root, "seg", "training", "pk_maps",
                                patient)
        assert sorted(os.listdir(got_dir)) == sorted(os.listdir(want_dir))
        for name in pmaps.PARAM_NAMES:
            got = np.load(os.path.join(got_dir, f"{name}_raw.npy"))
            want = np.load(os.path.join(want_dir, f"{name}_raw.npy"))
            assert got.shape == (32, 32) and np.isfinite(got).all()
            assert (np.abs(got - want) <= FIT_TOL).mean() >= FIT_SHARE
    # the port's index and loader read the artifacts the way JAX's do
    pidx = DatasetIndex(sub_tree, "train", SEQS, use_pk_maps=True)
    jidx = JaxIndex(sub_tree, "train", SEQS, use_pk_maps=True)
    assert len(pidx) == len(jidx) == 2
    for prec, jrec in zip(pidx.records, jidx.records):
        assert prec.pk_maps_path == jrec.pk_maps_path
        got = load_sample_raw(prec, use_pk_maps=True)
        want = jax_load_sample_raw(jrec, use_pk_maps=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert got[2].shape == (3, 32, 32) and got[2].max() > 0


def test_patient_shards_partition_the_split(tmp_path):
    root = make_synthetic_breadm(str(tmp_path / "b"), size=32, time_steps=8,
                                 patients_per_split=3, slices_per_patient=1,
                                 sequence_prefix="SUB")
    cfg = PKConfig(lm_iters=5)
    out_dir = os.path.join(root, "seg", "training", "pk_maps")
    pmaps.process_dataset(root, "training", cfg, device="cpu",
                          num_shards=2, shard_index=0)
    assert set(os.listdir(out_dir)) == {"P000", "P002"}
    pmaps.process_dataset(root, "training", cfg, device="cpu",
                          num_shards=2, shard_index=1)
    assert set(os.listdir(out_dir)) == {"P000", "P001", "P002"}
    with pytest.raises(ValueError):
        pmaps.process_dataset(root, "training", cfg, device="cpu",
                              num_shards=2, shard_index=2)


@pytest.mark.parametrize("flag", [["--data-parallel", "2"]])
def test_maps_cli_refuses_unported_flags(flag, sub_tree, tmp_path, capsys,
                                         monkeypatch):
    """--data-parallel, which the CLI took up: the port's voxel shards
    over two CPU replicas bit-equal to one device, and JAX's CLI over its
    2-device mesh within FIT_TOL on FIT_SHARE of the pixels; more GPUs
    than are visible are refused naming the count."""
    roots = {}
    for name in ("port", "one", "jax"):
        roots[name] = str(tmp_path / name)
        shutil.copytree(sub_tree, roots[name])
    argv = ["--splits", "training"]
    pmaps.main([roots["port"], *argv, *flag, "--device", "cpu"])
    assert "voxel-sharded fitting over 2 devices" in capsys.readouterr().out
    pmaps.main([roots["one"], *argv, "--device", "cpu"])
    jmaps.main([roots["jax"], *argv, *flag])
    for patient in ("P000", "P001"):
        got, one, want = (
            np.stack([np.load(os.path.join(root, "seg", "training",
                                           "pk_maps", patient,
                                           f"{n}_raw.npy"))
                      for n in pmaps.PARAM_NAMES]).reshape(3, -1).T
            for root in (roots["port"], roots["one"], roots["jax"]))
        np.testing.assert_array_equal(got, one)
        assert np.isfinite(got).all() and (got != 0).any()
        assert _share_within(got, want) >= FIT_SHARE
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="asks for 2 GPUs but 1 are"):
        pmaps.main([roots["port"], *argv, *flag])


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("flag", ["--enhanced", "--compare-aif", "--debug"])
def test_maps_cli_flag_now_runs(flag, tmp_path):
    """Each flag the CLI used to refuse, run on the CPU beside the JAX
    CLI on copies of one SUB tree: the same artifact files and finite
    maps. --debug (Adam) holds every raw map within FIT_TOL of JAX's on
    FIT_SHARE of its pixels; the enhanced fits of --enhanced and
    --compare-aif are ill-conditioned on this volume (JAX against its own
    run on frames with 1e-7 of noise keeps 19 % of the voxels at 1e-4),
    so they are held to JAX's own spread
    (tests/test_torch_pk_enhanced.py)."""
    from test_torch_pk_enhanced import (assert_within_jax_spread,
                                        jax_noisy_fit)

    root = make_synthetic_breadm(str(tmp_path / "port"), size=32,
                                 time_steps=8, splits=("val",),
                                 patients_per_split=1, slices_per_patient=1,
                                 sequence_prefix="SUB", seed=2)
    jax_root = str(tmp_path / "jax")
    shutil.copytree(root, jax_root)
    argv = ["--splits", "val", "--solver", "adam" if flag == "--debug"
            else "lm", flag]
    got = pmaps.main([root, *argv, "--device", "cpu"])
    jmaps.main([jax_root, *argv])
    sub = "pk_aif_comparison" if flag == "--compare-aif" else "pk_maps"
    assert got == {"val": os.path.join(root, "seg", "val", sub)}
    got_dir = os.path.join(root, "seg", "val", sub, "P000")
    want_dir = os.path.join(jax_root, "seg", "val", sub, "P000")
    assert _files(got_dir) == _files(want_dir)
    methods = (("population", "modified", "auto") if flag == "--compare-aif"
               else ("",))
    frames = pmaps._load_patient_frames(
        os.path.join(root, "seg", "val", "images", "P000"))
    for method in methods:
        g, w = (np.stack([np.load(os.path.join(d, method, f"{n}_raw.npy"))
                          for n in pmaps.PARAM_NAMES]).reshape(3, -1).T
                for d in (got_dir, want_dir))
        assert g.shape == (32 * 32, 3) and np.isfinite(g).all()
        if flag == "--debug":
            assert _share_within(g, w) >= FIT_SHARE
            continue
        spread = jax_noisy_fit(frames, JaxPKConfig(
            aif_method=method or "population")).reshape(3, -1).T
        assert_within_jax_spread(g, w, spread, method)
    if flag == "--debug":
        assert "debug/training_loss.png" in _files(got_dir)


def test_maps_cli_runs_on_the_cpu_when_asked(tmp_path):
    root = make_synthetic_breadm(str(tmp_path / "b"), size=32, time_steps=8,
                                 splits=("val",), patients_per_split=1,
                                 slices_per_patient=1, sequence_prefix="SUB")
    out = pmaps.main([root, "--splits", "val", "--device", "cpu"])
    files = os.listdir(os.path.join(out["val"], "P000"))
    assert {"ktrans.png", "ve.png", "vp.png", "combined_map.png"} <= set(files)
    if not torch.cuda.is_available():  # the default device is CUDA
        with pytest.raises(RuntimeError, match="cuda"):
            pmaps.main([root, "--splits", "val"])
