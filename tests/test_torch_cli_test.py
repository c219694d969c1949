"""The port's test entry point (stf_unet_tpu_torch/cli/test.py) and what its
flags reach, held against the JAX package's on the CPU: one seeded JAX UNet
(base_c = 4), saved with the JAX CheckpointManager and written into the
port's model dir as a reference .pth by `stf_unet_tpu.cli.migrate.
export_to_torch`; both packages' cli.test on one synthetic tree (48^2
slices, crop 32, 2 test patients x 2 slices). Also cli/train --test-only on
that checkpoint, cli/serve --model unet, the numpy metric and render
modules, and the refusals.

Tolerances:
  * confusion matrices: at most 0.1 % of the pixels in other cells (the
    logits agree to ~1e-6 of their max, so only near-ties can flip);
    dice, the per-patient report and the threshold sweep within 1e-5;
  * tiled masks >= 99.9 % equal: the JAX program blends its tiles in
    another summation order;
  * flip-TTA logits within 1e-5 * max |logit|;
  * the numpy metric and render modules: equal (the same code on the same
    inputs; renders compared in this process, with the same PIL and font).
"""

import glob
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from stf_unet_tpu.cli import test as jax_cli_test
from stf_unet_tpu.cli.migrate import export_to_torch
from stf_unet_tpu.core.config import OptimConfig
from stf_unet_tpu.metrics import binary as jax_binary
from stf_unet_tpu.metrics import patient as jax_patient
from stf_unet_tpu.metrics import surface as jax_surface
from stf_unet_tpu.models.registry import \
    preprocess_input as jax_preprocess_input
from stf_unet_tpu.models.unet import UNet as JaxUNet
from stf_unet_tpu.ops.tta import FlipTTAModel as JaxFlipTTAModel
from stf_unet_tpu.serve.engine import InferenceEngine as JaxEngine
from stf_unet_tpu.serve.tiled import TiledPredictor as JaxTiledPredictor
from stf_unet_tpu.serve.tiled import gaussian_window as jax_gaussian_window
from stf_unet_tpu.train.checkpoint import CheckpointManager
from stf_unet_tpu.train.schedule import warmup_poly_schedule
from stf_unet_tpu.train.state import TrainState, make_optimizer
from stf_unet_tpu.viz import comparison as jax_comparison
from stf_unet_tpu.viz import overlay as jax_overlay
from stf_unet_tpu_torch.cli import test as cli_test
from stf_unet_tpu_torch.cli import train as train_cli
from stf_unet_tpu_torch.cli.common import (checkpoint_path,
                                           restore_for_inference)
from stf_unet_tpu_torch.core.config import DataConfig
from stf_unet_tpu_torch.data.synthetic import make_synthetic_breadm
from stf_unet_tpu_torch.metrics import binary, patient, surface
from stf_unet_tpu_torch.models.registry import preprocess_input
from stf_unet_tpu_torch.ops.tta import FlipTTAModel
from stf_unet_tpu_torch.serve.tiled import (TiledPredictor, gaussian_window,
                                            plan_tiles)
from stf_unet_tpu_torch.viz import comparison, overlay
from test_torch_unet import seeded_unet_variables

BASE_C = 4
SIZE = 48
CROP = 32
REL_TOL = 1e-5
CONF_TOL = 1e-3  # share of pixels that may sit in other confusion cells
ARGS = ["--model", "unet", "--crop-size", str(CROP), "--base-c", str(BASE_C)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's small CPU steps: the test
    workers share the host's cores, and torch's default of a thread per
    core makes each tiny op of one worker wait on the others'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    base = tmp_path_factory.mktemp("cli_test")
    root = make_synthetic_breadm(str(base / "data"), size=SIZE,
                                 patients_per_split=2, slices_per_patient=2,
                                 seed=5)
    model = JaxUNet(num_classes=2, base_c=BASE_C)
    variables = seeded_unet_variables(model, 8, seed=11)
    optim = make_optimizer(OptimConfig(), warmup_poly_schedule(1e-3, 1, 1))
    state = TrainState(params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=optim.init(variables["params"]),
                       step=jnp.zeros((), jnp.int32))
    jax_dir = str(base / "jax")
    CheckpointManager(jax_dir, "unet").save("best", state, epoch=3,
                                            best_dice=0.5)
    port_dir = str(base / "port")
    os.makedirs(port_dir)
    export_to_torch(os.path.join(port_dir, "unet_best_model.pth"), "unet",
                    jax_dir, kind="best")
    return {"root": root, "jax": jax_dir, "port": port_dir, "base": base,
            "model": model, "variables": variables}


def _run_both(setup, name, *extra):
    out = {}
    for pkg, main, model_dir, device in (
            ("jax", jax_cli_test.main, setup["jax"], []),
            ("port", cli_test.main, setup["port"], ["--device", "cpu"])):
        out_dir = str(setup["base"] / f"{name}_{pkg}")
        out[pkg] = main(ARGS + ["--model-dir", model_dir, "--root",
                                setup["root"], "--output-dir", out_dir,
                                *extra, *device])
        out[f"{pkg}_dir"] = out_dir
    return out


def _assert_metrics_match(got, want):
    g, w = got["confusion_matrix"], np.asarray(want["confusion_matrix"])
    assert g.shape == w.shape and g.sum() == w.sum()
    assert np.abs(g - w).sum() / 2 <= CONF_TOL * w.sum()
    assert abs(got["dice"] - want["dice"]) <= REL_TOL
    assert abs(got["mean_metrics"]["miou"]
               - want["mean_metrics"]["miou"]) <= REL_TOL


def _assert_close_tree(got, want, path="report"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_close_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close_tree(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        if np.isnan(want):
            assert np.isnan(got), path
        else:
            assert abs(got - want) <= REL_TOL, (path, got, want)
    else:
        assert got == want, path


def _pngs(out_dir):
    return sorted(os.path.basename(p)
                  for p in glob.glob(os.path.join(out_dir, "*.png")))


def test_reports_match_jax(setup):
    out = _run_both(setup, "reports", "--per-patient", "--surface-metrics",
                    "--threshold-sweep")
    got, want = out["port"], out["jax"]
    # the seeded model predicts both classes, so every report has content
    assert (np.diag(got["confusion_matrix"]) > 0).all()
    _assert_metrics_match(got, want)
    _assert_close_tree(got["patient_report"], want["patient_report"])
    _assert_close_tree(got["threshold_sweep"], want["threshold_sweep"])
    names = _pngs(out["jax_dir"])
    assert len(names) == 4 and _pngs(out["port_dir"]) == names
    for report in ("patient_report.json", "threshold_sweep.json"):
        with open(os.path.join(out["jax_dir"], report)) as f:
            want_text = f.read()
        with open(os.path.join(out["port_dir"], report)) as f:
            assert f.read().count("\n") == want_text.count("\n")


def test_tiled_masks_match_jax(setup):
    model, variables = setup["model"], setup["variables"]
    port, _, _, _ = restore_for_inference(
        "unet", os.path.join(setup["port"], "unet_best_model.pth"),
        dtype="f32", device="cpu")
    cfg = DataConfig()
    rng = np.random.default_rng(3)
    # a canvas larger than the tile, and one smaller (edge-padded)
    for shape in ((8, 72, 56, 1), (8, 24, 40, 1)):
        image = rng.integers(0, 256, shape, dtype=np.uint8)
        want = JaxTiledPredictor(model, variables, cfg.mean, cfg.std,
                                 tile=CROP, overlap=0.5).predict(image)
        pred = TiledPredictor(port, cfg.mean, cfg.std, tile=CROP,
                              overlap=0.5, device="cpu")
        got = pred.predict(image)
        assert got.dtype == np.int32 and got.shape == want.shape
        assert (got == want).mean() >= 0.999
    assert plan_tiles(72, CROP, 16) == (0, 16, 32, 40)
    np.testing.assert_array_equal(gaussian_window(CROP),
                                  jax_gaussian_window(CROP))
    out = _run_both(setup, "tiled", "--tiled", "--tile-overlap", "0.5")
    _assert_metrics_match(out["port"], out["jax"])
    assert _pngs(out["port_dir"]) == _pngs(out["jax_dir"])


def test_tta_logits_match_jax(setup):
    model, variables = setup["model"], setup["variables"]
    port, _, _, _ = restore_for_inference(
        "unet", os.path.join(setup["port"], "unet_best_model.pth"),
        dtype="f32", device="cpu")
    x = np.random.default_rng(4).normal(
        size=(2, 8, CROP, CROP, 1)).astype(np.float32)
    jtta = JaxFlipTTAModel(model)
    want = np.asarray(jtta.apply(
        variables, jax_preprocess_input(jnp.asarray(x), jtta),
        train=False)["out"])
    tta = FlipTTAModel(port).eval()
    assert tta.input_format == "flat_channels" and tta.num_classes == 2
    with torch.no_grad():
        got = tta(preprocess_input(torch.from_numpy(x), tta))["out"].numpy()
        plain = port(preprocess_input(torch.from_numpy(x), port))["out"]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=REL_TOL * np.abs(want).max())
    assert np.abs(got - plain.numpy()).max() > 1e3 * REL_TOL  # it ensembles
    out = _run_both(setup, "tta", "--tta")
    _assert_metrics_match(out["port"], out["jax"])


def test_sigmoid_pred_mode_renders_the_same_masks(setup):
    out = _run_both(setup, "sigmoid", "--pred-mode", "sigmoid")
    names = _pngs(out["jax_dir"])
    assert _pngs(out["port_dir"]) == names
    for name in names:
        want = np.asarray(Image.open(os.path.join(out["jax_dir"], name)))
        got = np.asarray(Image.open(os.path.join(out["port_dir"], name)))
        assert got.shape == want.shape
        assert (got == want).all(axis=-1).mean() >= 0.999, name


def _masks(seed, n=3, h=24, w=20, classes=2):
    rng = np.random.default_rng(seed)
    pred = rng.integers(0, classes, (n, h, w))
    gt = rng.integers(0, classes, (n, h, w))
    gt[0, :3] = 255  # the padding label
    gt[1] = 0        # a slice without foreground
    pred[2] = 0
    return pred, gt


def _case_binary(tmp_path, seed):
    pred, gt = _masks(seed)
    logits = np.random.default_rng(seed).normal(size=pred.shape) * 3
    out = []
    for mod in (binary, jax_binary):
        sweep = mod.ThresholdSweep()
        for p, t in zip(1 / (1 + np.exp(-logits)), gt):
            sweep.update(p, t)
        report = sweep.report()
        out.append((mod.iou_score(logits, gt % 255),
                    mod.iou_score(pred, gt % 255),
                    mod.compute_metrics(pred, gt % 255), report,
                    mod.format_threshold_sweep(report)))
    return out


def _case_surface(tmp_path, seed):
    pred, gt = _masks(seed, classes=3)
    gt[2, 5:12, 4:9] = 1
    return [(mod.hd95_assd(pred[2] == 1, gt[2] == 1),
             mod.hd95_assd(pred[0] == 1, gt[0] == 1, spacing=(0.7, 1.3)),
             mod.surface_metrics(pred[0], gt[0], 3))
            for mod in (surface, jax_surface)]


def _case_patient(tmp_path, seed):
    pred, gt = _masks(seed, classes=3)
    out = []
    for mod in (patient, jax_patient):
        agg = mod.PatientAggregator(3, surface=True)
        for i, (p, t) in enumerate(zip(pred, gt)):
            agg.update(f"P{i % 2}", t, p)
        report = agg.report()
        out.append((report, mod.format_patient_report(report)))
    return out


def _case_overlay(tmp_path, seed):
    pred, gt = _masks(seed)
    raw = np.random.default_rng(seed).normal(size=pred.shape[1:])
    out = []
    for name, mod in (("port", overlay), ("jax", jax_overlay)):
        image = (np.abs(raw) * 80).astype(np.uint8)
        merged = mod.merge_images(image, pred[0] * 255, "0,0,255", alpha=0.3)
        path = mod.save_overlay(pred[1], raw[..., None],
                                str(tmp_path / name), 7, prefix="unet")
        out.append((merged, os.path.basename(path),
                    np.asarray(Image.open(path))))
    with pytest.raises(RuntimeError, match="cv2"):
        overlay.merge_images(raw, pred[0], border_only=True)
    return out


def _case_comparison(tmp_path, seed):
    pred, gt = _masks(seed)
    raw = np.random.default_rng(seed).normal(size=(2,) + pred.shape[1:])
    out = []
    for name, mod in (("port", comparison), ("jax", jax_comparison)):
        d = str(tmp_path / name)
        path = mod.save_comparison(pred[0].astype(np.float32),
                                   (gt[0] % 255).astype(np.float32), raw, d,
                                   base_name="unet", idx=5, dice_score=0.25,
                                   iou_score=0.125)
        mod.save_predictions(pred.astype(np.float32), d, base_name="p")
        out.append([(os.path.basename(p), np.asarray(Image.open(p)))
                    for p in sorted(glob.glob(os.path.join(d, "*.png")))]
                   + [os.path.basename(path)])
    return out


def _equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, float) and np.isnan(want):
        assert np.isnan(got)
    else:
        assert got == want


@pytest.mark.parametrize("case", [_case_binary, _case_surface,
                                  _case_patient, _case_overlay,
                                  _case_comparison],
                         ids=lambda f: f.__name__[len("_case_"):])
@pytest.mark.parametrize("seed", [0, 1])
def test_numpy_modules_match_jax(case, seed, tmp_path):
    got, want = case(tmp_path, seed)
    _equal(got, want)


def test_train_test_only_renders_each_test_record(setup, tmp_path):
    result = train_cli.run([
        "--data-path", setup["root"], "--model", "unet", "--model-base-c",
        str(BASE_C), "--test-only", "--save-dir", setup["port"],
        "--output-dir", str(tmp_path), "--device", "cpu",
        "--data-crop-size", str(CROP)])
    assert result["epochs"] == [] and result["steps"] == 0
    names = _pngs(tmp_path / "test_results")
    assert names == [f"unet_{i:03d}_compare.png" for i in range(4)]
    assert result["test_renders"] == 4
    tested = cli_test.main(ARGS + ["--model-dir", setup["port"], "--root",
                                   setup["root"], "--output-dir",
                                   str(tmp_path / "cli_test"), "--device",
                                   "cpu"])
    np.testing.assert_array_equal(result["test"]["confusion_matrix"],
                                  tested["confusion_matrix"])


def test_serve_answers_a_unet_request_with_the_jax_mask(setup):
    from stf_unet_tpu_torch.cli.serve import build_server, parse_args
    from stf_unet_tpu_torch.serve.client import SegmentationClient

    pth = os.path.join(setup["port"], "unet_best_model.pth")
    with pytest.raises(ValueError, match="not a stflstm checkpoint"):
        restore_for_inference("stflstm", pth, dtype="f32", device="cpu")
    server = build_server(parse_args(
        ["--model", "unet", "--weights", pth, "--port", "0", "--device",
         "cpu", "--dtype", "f32", "--crop-size", str(CROP), "--max-batch",
         "1"]))
    frames = np.random.default_rng(6).integers(0, 256, (8, 40, 52),
                                               dtype=np.uint8)
    server.start()
    try:
        client = SegmentationClient("http://%s:%d" % server.address,
                                    timeout=120)
        assert client.healthz()["model"] == "unet"
        mask = client.segment(frames)
    finally:
        server.stop()
    image, (h, w) = server.preprocess(frames)
    assert mask.shape == (h, w) == (CROP, 41)
    model, variables = setup["model"], setup["variables"]
    cfg = DataConfig()
    want = JaxEngine(model, variables, cfg.mean, cfg.std,
                     max_batch=1).predict(image[None])[0][:h, :w]
    x = (image[None].astype(np.float32) / 255.0 - cfg.mean) / cfg.std
    logits = np.asarray(model.apply(
        variables, jax_preprocess_input(jnp.asarray(x), model),
        train=False)["out"])[0, :h, :w]
    decided = (np.abs(logits[..., 1] - logits[..., 0])
               > 2 * REL_TOL * np.abs(logits).max())
    assert decided.mean() > 0.99
    np.testing.assert_array_equal(mask[decided], want[decided])


@pytest.mark.parametrize("argv,item", [
    (["--data-parallel", "2"], "data parallelism"),
    (["--data-parallel", "0"], "data parallelism"),
    (["--data-pack", "/p"], "dataset packs"),
])
def test_unported_flags_name_their_roadmap_item(argv, item, capsys):
    # both items are ported now: the flags parse to what they say (the
    # two-rank run is tests/test_torch_data_parallel.py's)
    if item == "dataset packs":  # the test split's pack root
        assert cli_test.parse_args(argv).data_pack == argv[1]
        return
    assert cli_test.parse_args(argv).data_parallel == int(argv[1])
    assert "ROADMAP.md" not in capsys.readouterr().err
    args = cli_test.parse_args(["--data-parallel", "1"])
    assert (args.model, args.device, args.dtype) == ("unet", "cuda", "f32")


def test_cli_test_refuses_missing_cuda(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        cli_test.main(["--model-dir", setup["port"], "--root",
                       setup["root"]])


def test_restore_reads_the_checkpoint_and_warns_on_mismatch(setup, tmp_path,
                                                            capsys):
    """A UNet checkpoint's width, classes and PK maps come from its
    weights, its mask format from its config; explicit arguments win, and
    a sequence / PK-map choice unlike the training run's is warned about,
    as by the JAX package's cli/common."""
    import json

    from stf_unet_tpu_torch.core.config import ModelConfig
    from stf_unet_tpu_torch.models.registry import create_model

    sd = create_model(ModelConfig(model="unet", base_c=6, num_classes=2,
                                  use_pk_maps=True)).state_dict()
    config = {"data": {"crop_size": 40, "base_size": 48, "mean": 0.5,
                       "std": 0.2, "mask_format": "index",
                       "use_subtraction": True, "use_pk_maps": True}}
    path = str(tmp_path / "unet_best_model_pk.pth")
    torch.save({"model": sd, "epoch": 1, "config": json.dumps(config)}, path)
    model, cfg, model_cfg, _ = restore_for_inference(
        "unet", path, dtype="f32", device="cpu")
    assert (model_cfg.base_c, model_cfg.total_classes) == (6, 3)
    assert model_cfg.use_pk_maps and model_cfg.pk_channels == 3
    assert cfg.use_pk_maps and cfg.mask_format == "index"
    assert (cfg.crop_size, cfg.mean, cfg.std) == (40, 0.5, 0.2)
    out = capsys.readouterr().out
    assert "WARNING" in out and "--use-subtraction=True" in out
    assert "--use-pk-maps" not in out
    _, cfg, _, _ = restore_for_inference(
        "unet", path, use_subtraction=True, use_pk_maps=False,
        mask_format="binary", crop_size=32, dtype="f32", device="cpu")
    assert (cfg.mask_format, cfg.crop_size) == ("binary", 32)
    out = capsys.readouterr().out
    assert "--use-pk-maps=True" in out and "--use-subtraction" not in out
    assert checkpoint_path(str(tmp_path), "unet", True) == path
    with pytest.raises(FileNotFoundError, match="unet_best_model.pth"):
        checkpoint_path(str(tmp_path), "unet")
