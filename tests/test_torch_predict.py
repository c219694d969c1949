"""The port's labels-free entry points (stf_unet_tpu_torch/cli/predict.py,
cli/pipeline.py, viz/overlay.render_pk_overlay) held against the JAX
package's on the CPU: one seeded JAX UNet (base_c = 4; one with the PK
maps' 3 extra input channels; one small STF-LSTM-UNet run, so the LSTM
routing is crossed), saved with the JAX CheckpointManager and written
into the port's model dir by `stf_unet_tpu.cli.migrate.export_to_torch`
(tests/test_torch_cli_test.py's pattern); both packages' CLIs on one
synthetic tree (48^2 slices, 2 test patients x 2 slices, crop 32).

Tolerances:
  * masks and overlays: the same files, each mask >= 99.9 % equal (the
    logits agree to ~1e-6 of their max; only near-ties flip), as
    tests/test_torch_cli_test.py holds cli/test;
  * --save-probs: float16 probabilities within 2^-10 + 1e-5 (one float16
    spacing below 1, plus the logits' difference);
  * --tiled masks >= 99.9 % equal (the JAX program blends its tiles in
    another summation order); --tta masks likewise;
  * --pk-fit: the `_pk.npz` maps within FIT_TOL 1e-4 on FIT_SHARE 0.99 of
    the pixels (tests/test_torch_pk.py); with --pk-enhanced, the
    ill-conditioned enhanced fit is held to JAX's own spread under 1e-7
    of noise (tests/test_torch_pk_enhanced.py);
  * render_pk_overlay: equal to the JAX function's with cv2 hidden (its
    own alpha fallback, the only branch the port has);
  * cli.pipeline: the renders' file set, and the Ktrans each render
    draws against JAX's on the terms of --pk-fit.
"""

import glob
import os
import shutil
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from stf_unet_tpu.cli import pipeline as jax_pipeline
from stf_unet_tpu.cli import predict as jax_predict
from stf_unet_tpu.cli.migrate import export_to_torch
from stf_unet_tpu.core.config import OptimConfig
from stf_unet_tpu.core.config import PKConfig as JaxPKConfig
from stf_unet_tpu.data.index import DatasetIndex as JaxIndex
from stf_unet_tpu.data.loader import load_sample_raw as jax_load_sample_raw
from stf_unet_tpu.models.stf_lstm_unet import STFLSTMUNet as JaxSTFLSTMUNet
from stf_unet_tpu.models.unet import UNet as JaxUNet
from stf_unet_tpu.train.checkpoint import CheckpointManager
from stf_unet_tpu.train.schedule import warmup_poly_schedule
from stf_unet_tpu.train.state import TrainState, make_optimizer
from stf_unet_tpu.viz import overlay as jax_overlay
from stf_unet_tpu_torch.cli import pack as pack_cli
from stf_unet_tpu_torch.cli import pipeline
from stf_unet_tpu_torch.cli import predict
from stf_unet_tpu_torch.data.synthetic import make_synthetic_breadm
from stf_unet_tpu_torch.viz import overlay
from test_torch_pk_enhanced import assert_within_jax_spread, jax_noisy_fit
from test_torch_unet import seeded_unet_variables

BASE_C = 4
SIZE = 48
CROP = 32
FIT_TOL, FIT_SHARE = 1e-4, 0.99
MASK_SHARE = 0.999
PROB_TOL = 2.0 ** -10 + 1e-5
ARGS = ["--model", "unet", "--crop-size", str(CROP), "--base-c", str(BASE_C)]


def _save(base, name, model_name, variables):
    """A JAX checkpoint of `variables` and its port export; the two
    model dirs."""
    optim = make_optimizer(OptimConfig(), warmup_poly_schedule(1e-3, 1, 1))
    state = TrainState(params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=optim.init(variables["params"]),
                       step=jnp.zeros((), jnp.int32))
    jax_dir, port_dir = str(base / f"{name}_jax"), str(base / f"{name}_port")
    pk = name == "pk"
    CheckpointManager(jax_dir, model_name, "_pk" if pk else "").save(
        "best", state, epoch=3, best_dice=0.5)
    os.makedirs(port_dir)
    suffix = "_pk" if pk else ""
    export_to_torch(os.path.join(port_dir,
                                 f"{model_name}_best_model{suffix}.pth"),
                    model_name, jax_dir, kind="best", use_pk_maps=pk)
    return jax_dir, port_dir


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    base = tmp_path_factory.mktemp("predict")
    root = make_synthetic_breadm(str(base / "data"), size=SIZE,
                                 patients_per_split=2, slices_per_patient=2,
                                 with_pk_maps=True, seed=5)
    images = os.path.join(root, "seg", "test", "images")
    npz = str(base / "npz")
    os.makedirs(npz)
    seqs = [f"VIBRANT+C{i}" for i in range(1, 9)]
    for name in ("slice_000", "slice_001"):
        frames = np.stack([np.asarray(Image.open(os.path.join(
            images, "P000", s, f"{name}.png")).convert("L")) for s in seqs])
        np.savez(os.path.join(npz, f"P000_{name}.npz"), frames=frames)
    out = {"root": root, "images": images, "npz": npz, "base": base}
    out["unet"] = _save(base, "unet", "unet", seeded_unet_variables(
        JaxUNet(num_classes=2, base_c=BASE_C), 8, seed=11))
    out["pk"] = _save(base, "pk", "unet", seeded_unet_variables(
        JaxUNet(num_classes=2, base_c=BASE_C), 11, seed=12))
    return out


def _run_both(setup, name, input_path, *extra, model="unet", args=ARGS):
    jax_dir, port_dir = setup[model]
    out = {}
    for pkg, main, model_dir, device in (
            ("jax", jax_predict.main, jax_dir, []),
            ("port", predict.main, port_dir, ["--device", "cpu"])):
        out_dir = str(setup["base"] / f"out_{name}_{pkg}")
        out[pkg] = main(args + ["--input", input_path, "--model-dir",
                                model_dir, "--output-dir", out_dir, *extra,
                                *device])
        out[f"{pkg}_dir"] = out_dir
    return out


def _files(d, pattern="*"):
    return sorted(os.path.relpath(p, d) for p in
                  glob.glob(os.path.join(d, "**", pattern), recursive=True)
                  if os.path.isfile(p))


def _assert_masks_match(out, share=MASK_SHARE):
    names = _files(out["jax_dir"])
    assert names and _files(out["port_dir"]) == names
    masks = [n for n in names if n.endswith("_mask.png")]
    assert masks
    for name in masks:
        want = np.asarray(Image.open(os.path.join(out["jax_dir"], name)))
        got = np.asarray(Image.open(os.path.join(out["port_dir"], name)))
        assert got.shape == want.shape, name
        assert (got == want).mean() >= share, name
    assert set(np.unique(got)) <= {0, 255}
    return masks


@pytest.mark.parametrize("kind", ["tree", "patient", "npz_dir", "npz_file"])
def test_predict_masks_match_jax(setup, kind):
    input_path = {"tree": setup["images"],
                  "patient": os.path.join(setup["images"], "P001"),
                  "npz_dir": setup["npz"],
                  "npz_file": os.path.join(setup["npz"],
                                           "P000_slice_001.npz")}[kind]
    out = _run_both(setup, kind, input_path)
    masks = _assert_masks_match(out)
    want = {"tree": 4, "patient": 2, "npz_dir": 2, "npz_file": 1}[kind]
    assert len(masks) == out["port"]["slices"] == want
    assert out["port"]["patients"] == out["jax"]["patients"]
    assert set(out["port"]["seconds"]) == {"restore", "forward", "pk_fit",
                                           "total"}


def test_save_probs_full_size_match_jax(setup):
    out = _run_both(setup, "probs", setup["images"], "--save-probs",
                    "--full-size", "--no-overlay")
    _assert_masks_match(out)
    probs = _files(out["jax_dir"], "*_probs.npz")
    assert len(probs) == 4 and _files(out["port_dir"], "*_probs.npz") == probs
    for name in probs:
        want = np.load(os.path.join(out["jax_dir"], name))["probs"]
        got = np.load(os.path.join(out["port_dir"], name))["probs"]
        assert got.dtype == np.float16 and got.shape == want.shape
        np.testing.assert_allclose(got.astype(np.float32),
                                   want.astype(np.float32), atol=PROB_TOL,
                                   rtol=0)
    masks = _files(out["port_dir"], "*_mask.png")
    assert Image.open(os.path.join(out["port_dir"], masks[0])).size == (
        SIZE, SIZE)


@pytest.mark.parametrize("flag", ["--tta", "--tiled"])
def test_tta_and_tiled_match_jax(setup, flag):
    out = _run_both(setup, flag[2:], setup["images"], flag)
    _assert_masks_match(out)


def test_use_pk_maps_matches_jax(setup, capsys):
    pk_dir = str(setup["base"] / "pk_maps")
    shutil.copytree(os.path.join(setup["root"], "seg", "test", "pk_maps"),
                    pk_dir)
    os.remove(os.path.join(pk_dir, "P001", "ve.png"))  # zero-filled
    out = _run_both(setup, "pk_maps", setup["images"], "--use-pk-maps",
                    "--pk-maps", pk_dir, model="pk")
    _assert_masks_match(out)
    assert capsys.readouterr().out.count("zero-filling") == 2 * 2
    with pytest.raises(SystemExit, match="--pk-maps"):
        predict.main(ARGS + ["--input", setup["images"], "--use-pk-maps",
                             "--model-dir", setup["pk"][1], "--device",
                             "cpu"])


@pytest.mark.parametrize("enhanced", [False, True],
                         ids=["plain", "enhanced"])
def test_pk_fit_matches_jax(setup, enhanced):
    flags = ["--pk-fit", "--no-overlay"] + (["--pk-enhanced"] if enhanced
                                            else [])
    out = _run_both(setup, f"pkfit_{enhanced}", os.path.join(
        setup["images"], "P000"), *flags)
    _assert_masks_match(out)
    fits = _files(out["jax_dir"], "*_pk.npz")
    assert len(fits) == 2 and _files(out["port_dir"], "*_pk.npz") == fits
    assert _files(out["port_dir"], "*_pk.png") == _files(out["jax_dir"],
                                                         "*_pk.png")
    assert out["port"]["seconds"]["pk_fit"] > 0
    for name in fits:
        want = np.load(os.path.join(out["jax_dir"], name))
        got = np.load(os.path.join(out["port_dir"], name))
        w, g = (np.stack([m[k] for k in ("ktrans", "ve", "vp")])
                .reshape(3, -1).T for m in (want, got))
        assert g.dtype == np.float32 and np.isfinite(g).all()
        if not enhanced:
            assert ((np.abs(g - w) <= FIT_TOL).all(axis=1).mean()
                    >= FIT_SHARE), name
            continue
        slice_name = name.split("/")[-1][:-len("_pk.npz")]
        frames = np.stack([np.asarray(Image.open(os.path.join(
            setup["images"], "P000", f"VIBRANT+C{i}",
            f"{slice_name}.png")).convert("L")) for i in range(1, 9)])
        spread = jax_noisy_fit(frames, JaxPKConfig(
            time_points=tuple(float(i) for i in range(8))))
        assert_within_jax_spread(g, w, spread.reshape(3, -1).T, name)


def test_render_pk_overlay_matches_jax_without_cv2(monkeypatch):
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (20, 24), dtype=np.uint8)
    ktrans = rng.uniform(0, 0.3, (20, 24)).astype(np.float32)
    pred = (rng.uniform(0, 1, (20, 24)) > 0.6).astype(np.uint8)
    got = overlay.render_pk_overlay(base, ktrans, pred)
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "cv2", None)
        m.setattr(jax_overlay, "_HAS_CV2", False)
        want = jax_overlay.render_pk_overlay(base, ktrans, pred)
        zero = jax_overlay.render_pk_overlay(base, 0 * ktrans, pred)
    assert got.dtype == np.uint8 and got.shape == (20, 24, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        overlay.render_pk_overlay(base, 0 * ktrans, pred), zero)
    # with cv2 the JAX function draws contours instead: another picture
    assert not np.array_equal(jax_overlay.render_pk_overlay(base, ktrans,
                                                            pred), got)


def test_stflstm_predict_matches_jax(setup):
    model = JaxSTFLSTMUNet(num_classes=2, time_steps=8)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.key(0), jnp.zeros((1, 8, CROP, CROP, 1)), train=False))
    rng = np.random.default_rng(1)

    def draw(path, leaf):  # fan-in scaled kernels, BN statistics near 1
        name = path[-1].key
        if name == "kernel":
            a = rng.normal(0, 1 / np.sqrt(np.prod(leaf.shape[:-1])),
                           leaf.shape)
        elif name in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, leaf.shape)
        else:
            a = rng.normal(0.0, 0.1, leaf.shape)
        return jnp.asarray(a, leaf.dtype)

    setup["stflstm"] = _save(setup["base"], "stflstm", "stflstm",
                             jax.tree_util.tree_map_with_path(draw, shapes))
    out = _run_both(setup, "stflstm", os.path.join(setup["images"], "P001"),
                    model="stflstm", args=["--model", "stflstm",
                                           "--crop-size", str(CROP)])
    _assert_masks_match(out)


def _pipeline_renders(monkeypatch, module):
    """Run a pipeline module's renders through a recorder of the Ktrans
    each draws."""
    seen = []
    real = module.render_pk_overlay

    def record(base, ktrans, pred):
        seen.append(np.asarray(ktrans))
        return real(base, ktrans, pred)

    monkeypatch.setattr(module, "render_pk_overlay", record)
    return seen


@pytest.fixture(scope="module")
def jax_pipeline_runs():
    return {}


def _run_pipeline(setup, monkeypatch, pkg, flags, cache):
    """(result, render files, the Ktrans each render drew) of one
    package's cli.pipeline; JAX's runs once per flag set (a pack's
    samples are the decoded ones byte for byte, tests/test_torch_pack.py,
    so JAX's plain run is what a --data-pack run gives)."""
    tag = "enhanced" if "--enhanced" in flags else "plain"
    if pkg == "jax" and tag in cache:
        return cache[tag]
    module, (jax_dir, port_dir) = ((jax_pipeline if pkg == "jax"
                                    else pipeline), setup["unet"])
    seen = _pipeline_renders(monkeypatch, module)
    out_dir = str(setup["base"] / f"pipe_{pkg}_{'_'.join(flags[:1])}")
    result = module.main(["--root", setup["root"], "--model", "unet",
                          "--model-dir", jax_dir if pkg == "jax"
                          else port_dir, "--output-dir", out_dir,
                          "--base-c", str(BASE_C), *flags,
                          *([] if pkg == "jax" else ["--device", "cpu"])])
    run = (result, _files(out_dir), seen)
    if pkg == "jax":
        cache[tag] = run
    return run


@pytest.mark.parametrize("flags", [[], ["--enhanced"], ["--data-pack"]],
                         ids=["plain", "enhanced", "pack"])
def test_pipeline_matches_jax(setup, flags, monkeypatch, jax_pipeline_runs):
    if flags == ["--data-pack"]:
        pack = str(setup["base"] / "pack")
        pack_cli.main(["--data-path", setup["root"], "--output", pack])
        flags = ["--data-pack", pack]
    runs = {pkg: _run_pipeline(setup, monkeypatch, pkg, flags,
                               jax_pipeline_runs)
            for pkg in ("jax", "port")}
    (got, got_files, got_k), (want, want_files, want_k) = (runs["port"],
                                                           runs["jax"])
    assert got["samples"] == want["samples"] == 4
    assert got_files == want_files == [f"P00{p}_00{i}_pipeline.png" for
                                       p, i in ((0, 0), (0, 1), (1, 2),
                                                (1, 3))]
    assert got["avg_seconds"] > 0
    assert len(got_k) == len(want_k) == 4
    index = JaxIndex(setup["root"], "test",
                     tuple(f"VIBRANT+C{i}" for i in range(1, 9)))
    for rec, g, w in zip(index.records, got_k, want_k):
        assert g.shape == w.shape == (SIZE, SIZE)
        assert np.isfinite(g).all()
        if "--enhanced" not in flags:
            assert (np.abs(g - w) <= FIT_TOL).mean() >= FIT_SHARE
            continue
        frames = jax_load_sample_raw(rec)[0]
        spread = jax_noisy_fit(frames, JaxPKConfig(
            time_points=tuple(float(i) for i in range(8))))[0]
        assert_within_jax_spread(g.reshape(-1, 1), w.reshape(-1, 1),
                                 spread.reshape(-1, 1), rec.patient_id)


def test_pipeline_runs_random_weights_without_a_checkpoint(setup, tmp_path,
                                                          capsys):
    result = pipeline.main(["--root", setup["root"], "--model", "unet",
                            "--model-dir", str(tmp_path / "none"),
                            "--output-dir", str(tmp_path / "out"),
                            "--base-c", str(BASE_C), "--device", "cpu"])
    assert "no checkpoint found" in capsys.readouterr().out
    assert result["samples"] == 4 and len(os.listdir(tmp_path / "out")) == 4


@pytest.mark.parametrize("argv,item", [
    (["--data-parallel", "2"], "data-parallel inference"),
    (["--data-parallel", "0"], "data-parallel inference"),
])
def test_predict_refusals_name_their_item(argv, item, capsys):
    with pytest.raises(SystemExit):
        predict.parse_args(["--input", "x", *argv])
    err = capsys.readouterr().err
    assert "ROADMAP.md" in err and item in err
    args = predict.parse_args(["--input", "x"])
    assert (args.device, args.dtype, args.pk_solver) == ("cuda", "f32", "lm")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            pipeline.main(["--root", "/nonexistent", "--model-dir", "/none"])
