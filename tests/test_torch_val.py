"""The port's cli/val (stf_unet_tpu_torch/cli/val.py) against the JAX
package's cli/val on the CPU: one seeded JAX UNet (base_c = 4) saved with
the JAX CheckpointManager and written into the port's model dir as a
reference .pth by `stf_unet_tpu.cli.migrate.export_to_torch`; both CLIs
on one synthetic tree (48^2 slices, crop 32, 2 val patients x 2 slices)
with the same YAML config.

Tolerances: IoU and Dice within 1e-4 (the logits agree to ~1e-6 of their
max, so a thresholded pixel flips only at a near-tie); the confusion
matrix and the mask JPGs equal. The config read over the defaults, or
written with them when missing, equals JAX's, key for key and byte for
byte.
"""

import os

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import jax.numpy as jnp

from stf_unet_tpu.cli import val as jax_val
from stf_unet_tpu.cli.migrate import export_to_torch
from stf_unet_tpu.core.config import OptimConfig
from stf_unet_tpu.models.unet import UNet as JaxUNet
from stf_unet_tpu.train.checkpoint import CheckpointManager
from stf_unet_tpu.train.schedule import warmup_poly_schedule
from stf_unet_tpu.train.state import TrainState, make_optimizer
from stf_unet_tpu_torch.cli import val
from stf_unet_tpu_torch.data.synthetic import make_synthetic_breadm
from test_torch_unet import seeded_unet_variables

BASE_C = 4
METRIC_TOL = 1e-4
CONFIG = {**val.DEFAULT_CONFIG, "arch": "unet", "base_c": BASE_C,
          "crop_size": 32, "batch_size": 2}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's small CPU steps: the test
    workers share the host's cores, and torch's default of a thread per
    core makes each tiny op of one worker wait on the others'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("config", [
    None, val.DEFAULT_CONFIG, CONFIG,
    {**CONFIG, "use_subtraction": True, "num_classes": 3, "lr": 0.001,
     "note": "x/y.z", "nested": {"a": [1, 2]}},
])
def test_config_matches_jax(config, tmp_path, capsys):
    """The config read over the defaults, or written with them when the
    file is missing (config None), as JAX's cli/val does."""
    paths = {}
    for name in ("jax", "port"):
        paths[name] = str(tmp_path / name / "config.yml")
        if config is not None:
            os.makedirs(os.path.dirname(paths[name]))
            with open(paths[name], "w") as f:
                yaml.safe_dump(config, f)
    want = jax_val.load_or_create_config(paths["jax"])
    got = val.load_or_create_config(paths["port"])
    assert got == want == {**val.DEFAULT_CONFIG, **(config or {})}
    assert open(paths["port"]).read() == open(paths["jax"]).read()
    if config is None:
        assert capsys.readouterr().out.count("Config file not found") == 2


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    base = tmp_path_factory.mktemp("cli_val")
    root = make_synthetic_breadm(str(base / "data"), size=48,
                                 patients_per_split=2, slices_per_patient=2,
                                 seed=7)
    model = JaxUNet(num_classes=2, base_c=BASE_C)
    variables = seeded_unet_variables(model, 8, seed=22)  # ~39 % foreground
    optim = make_optimizer(OptimConfig(), warmup_poly_schedule(1e-3, 1, 1))
    state = TrainState(params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=optim.init(variables["params"]),
                       step=jnp.zeros((), jnp.int32))
    jax_dir = str(base / "jax")
    CheckpointManager(jax_dir, "unet").save("best", state, epoch=2,
                                            best_dice=0.4)
    port_dir = str(base / "port")
    os.makedirs(port_dir)
    export_to_torch(os.path.join(port_dir, "unet_best_model.pth"), "unet",
                    jax_dir, kind="best")
    cfg = str(base / "config.yml")
    with open(cfg, "w") as f:
        yaml.safe_dump(CONFIG, f)
    return {"root": root, "jax": jax_dir, "port": port_dir, "base": base,
            "config": cfg}


def _jpgs(base, name):
    d = os.path.join(base, "outputs", name, "0")
    return {f: np.asarray(Image.open(os.path.join(d, f)))
            for f in sorted(os.listdir(d))}


def test_val_matches_jax(setup, monkeypatch, capsys):
    monkeypatch.chdir(setup["base"])
    jax_mats = []  # the matrix JAX's cli/val reports on

    def spy(mat, *a, **k):
        jax_mats.append(np.asarray(mat))
        return report(mat, *a, **k)

    report = jax_val.confusion_report
    monkeypatch.setattr(jax_val, "confusion_report", spy)
    args = ["--root", setup["root"], "--config", setup["config"]]
    want = jax_val.main(args + ["--model-path", setup["jax"], "--name",
                                "jax"])
    got = val.main(args + ["--model-path", setup["port"], "--name", "port",
                           "--device", "cpu"])
    assert abs(got["iou"] - want["iou"]) <= METRIC_TOL
    assert abs(got["dice"] - want["dice"]) <= METRIC_TOL
    assert got["dice"] > 0.05  # the seeded model predicts foreground
    (jax_mat,) = jax_mats
    np.testing.assert_array_equal(got["confusion_matrix"], jax_mat)
    assert got["report"]["global_accuracy"] == pytest.approx(
        want["report"]["global_accuracy"], abs=1e-12)
    assert got["report"]["class_metrics"] == pytest.approx(
        want["report"]["class_metrics"], abs=1e-12)
    assert got["device_time"] > 0 and got["batches"] == 2
    masks_j, masks_p = _jpgs(setup["base"], "jax"), _jpgs(setup["base"],
                                                          "port")
    assert masks_p.keys() == masks_j.keys() and len(masks_p) == 4
    for f in masks_j:
        np.testing.assert_array_equal(masks_p[f], masks_j[f])
    out = capsys.readouterr().out
    assert "Average device time" in out


def test_val_data_parallel_replicas(setup, monkeypatch, capsys, tmp_path):
    """Two CPU replicas: the same metrics; a config batch that does not
    divide warns and runs whole."""
    monkeypatch.chdir(setup["base"])
    args = ["--root", setup["root"], "--config", setup["config"],
            "--model-path", setup["port"], "--device", "cpu"]
    one = val.main(args + ["--name", "one"])
    two = val.main(args + ["--name", "two", "--data-parallel", "2"])
    assert "batches split over 2 devices" in capsys.readouterr().out
    assert (two["iou"], two["dice"]) == (one["iou"], one["dice"])
    np.testing.assert_array_equal(two["confusion_matrix"],
                                  one["confusion_matrix"])
    odd = str(tmp_path / "odd.yml")
    with open(odd, "w") as f:
        yaml.safe_dump({**CONFIG, "batch_size": 3}, f)
    three = val.main(["--root", setup["root"], "--config", odd,
                      "--model-path", setup["port"], "--device", "cpu",
                      "--name", "three", "--data-parallel", "2"])
    assert "is not a multiple of 2" in capsys.readouterr().out
    # IoU / Dice are taken per batch, so only the pixel counts compare
    np.testing.assert_array_equal(three["confusion_matrix"],
                                  one["confusion_matrix"])
