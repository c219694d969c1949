"""Serving takes a checkpoint's own training config (cli/common
.restore_for_inference), as the JAX package's cli/common does: a
checkpoint trained through the port's cli/train at crop 48 with a
non-default mean and std is served, with no --crop-size, exactly as a
server given those settings explicitly. An explicit --crop-size still
wins; a checkpoint without a config keeps the defaults, and one whose
config cannot be read prints a note and keeps them.

CPU, small sizes: a synthetic BreaDM tree at 56^2, one epoch at batch 2.
"""

import json
import os

import numpy as np
import pytest
import torch

from stf_unet_tpu_torch.cli import train as train_cli
from stf_unet_tpu_torch.cli.common import (restore_for_inference,
                                           saved_data_settings)
from stf_unet_tpu_torch.cli.serve import build_server, parse_args
from stf_unet_tpu_torch.core.config import DataConfig
from stf_unet_tpu_torch.data.synthetic import make_synthetic_breadm
from stf_unet_tpu_torch.data.transforms import normalize
from stf_unet_tpu_torch.models.registry import preprocess_input
from stf_unet_tpu_torch.serve.http import SegmentationServer

BASE, CROP, MEAN, STD = 56, 48, 0.5, 0.2
T_STEPS = 8
SERVE_FLAGS = ["--port", "0", "--device", "cpu", "--dtype", "f32",
               "--max-batch", "2", "--batch-window-ms", "1"]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_config")
    data = str(root / "breadm")
    make_synthetic_breadm(data, size=BASE, seed=5)
    weights = str(root / "weights")
    train_cli.run(["--data-path", data, "--epochs", "1",
                   "--save-dir", weights, "--output-dir", str(root / "out"),
                   "--device", "cpu", "--batch-size", "2",
                   "--data-base-size", str(BASE),
                   "--data-crop-size", str(CROP),
                   "--data-mean", str(MEAN), "--data-std", str(STD)])
    return os.path.join(weights, "stflstm_best_model.pth")


def _logits(server, frames):
    """One request's logits through the server's own preprocessing and
    normalization."""
    image, _ = server.preprocess(frames)
    eng = server.engine
    x = normalize(torch.from_numpy(image[None]), eng.mean, eng.std)
    with torch.inference_mode():
        return eng.model(preprocess_input(x, eng.model))["out"]


def test_serving_takes_the_checkpoints_training_config(checkpoint):
    served = build_server(parse_args(["--weights", checkpoint,
                                      *SERVE_FLAGS]))
    # the serve CLI's only data flag is --crop-size: the explicit server
    # is given the training flags' values as a DataConfig
    model, _, _, _ = restore_for_inference(
        "stflstm", checkpoint, crop_size=CROP, dtype="f32", device="cpu")
    explicit = SegmentationServer(
        model, DataConfig(base_size=BASE, crop_size=CROP, mean=MEAN,
                          std=STD),
        model_name="stflstm", port=0, max_batch=2, device="cpu")
    explicit.engine.warmup(T_STEPS, CROP, CROP)
    for srv in (served, explicit):
        srv.start()
    try:
        cfg = served.data_cfg
        assert (cfg.crop_size, cfg.base_size, cfg.mean, cfg.std) == (
            CROP, BASE, MEAN, STD)
        assert (served.engine.mean, served.engine.std) == (MEAN, STD)
        assert served.engine.seen_shapes == explicit.engine.seen_shapes
        assert (2, T_STEPS, CROP, CROP, 1) in served.engine.seen_shapes
        frames = np.random.default_rng(0).integers(
            0, 256, (T_STEPS, 70, 90), dtype=np.uint8)
        # short edge 70 -> the training crop 48, 90 -> 61; stride-padded
        assert served.preprocess(frames)[1] == (CROP, 61)
        got, want = _logits(served, frames), _logits(explicit, frames)
        assert got.shape == want.shape == (1, 64, 64, 2)
        assert torch.equal(got, want)
        assert np.array_equal(served.segment(frames),
                              explicit.segment(frames))
    finally:
        for srv in (served, explicit):
            srv.stop()


def test_an_explicit_crop_size_wins(checkpoint):
    _, cfg, _, _ = restore_for_inference(
        "stflstm", checkpoint, crop_size=32, dtype="f32", device="cpu")
    assert (cfg.crop_size, cfg.base_size, cfg.mean, cfg.std) == (
        32, BASE, MEAN, STD)


def test_a_checkpoint_without_a_config_keeps_the_defaults(checkpoint,
                                                          tmp_path):
    ckpt = torch.load(checkpoint, map_location="cpu", weights_only=True)
    bare = str(tmp_path / "bare.pth")
    torch.save({"model": ckpt["model"], "epoch": ckpt["epoch"]}, bare)
    _, cfg, _, meta = restore_for_inference("stflstm", bare, dtype="f32",
                                            device="cpu")
    assert "config" not in meta
    assert cfg == DataConfig()


@pytest.mark.parametrize("raw", [
    "{not json", json.dumps({"model": {}}), json.dumps({"data": []}),
    json.dumps({"data": {"crop_size": 48}}),
    json.dumps({"data": {"crop_size": "x", "base_size": 56, "mean": 0.5,
                         "std": 0.2}})])
def test_an_unreadable_config_prints_a_note_and_keeps_the_defaults(raw,
                                                                   capsys):
    assert saved_data_settings({"config": raw}) == {}
    # a config that holds no "data" (cli/migrate's {"migrated_from": ...},
    # cli/average's) has no data settings: the defaults, without a note
    noted = raw != json.dumps({"model": {}})
    assert ("unreadable checkpoint config" in capsys.readouterr().out) \
        == noted


def test_saved_data_settings_reads_the_training_run():
    raw = json.dumps({"data": {"crop_size": 48, "base_size": 56,
                               "mean": 0.5, "std": 0.2, "prefetch": 2}})
    assert saved_data_settings({"config": raw}) == {
        "crop_size": 48, "base_size": 56, "mean": 0.5, "std": 0.2}
    assert saved_data_settings({"config": ""}) == {}
    assert saved_data_settings({}) == {}
