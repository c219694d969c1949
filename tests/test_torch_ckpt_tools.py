"""The port's checkpoint CLIs (stf_unet_tpu_torch/cli/{average, migrate,
export}.py) against the JAX package's on the CPU, on seeded JAX UNets
(base_c = 4) carried into the port's layout by
`stf_unet_tpu.cli.migrate.export_to_torch`.

Tolerances: the average leafwise within 1e-7 of max(1, |value|) (both
sum the same float32 leaves in the same order); migrate's tensors
bit-equal and key for key in both directions; the exported artifact
against the eager model within 1e-5 (cli/export's own --check bound) at
the symbolic batch's other sizes too, its sidecar's keys JAX's.
"""

import argparse
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stf_unet_tpu.cli import average as jax_average
from stf_unet_tpu.cli import export as jax_export
from stf_unet_tpu.cli import migrate as jax_migrate
from stf_unet_tpu.core.config import OptimConfig
from stf_unet_tpu.models.unet import UNet as JaxUNet
from stf_unet_tpu.train.checkpoint import CheckpointManager
from stf_unet_tpu.train.schedule import warmup_poly_schedule
from stf_unet_tpu.train.state import TrainState, make_optimizer
from stf_unet_tpu_torch.cli import average, export, migrate
from stf_unet_tpu_torch.cli.common import restore_for_inference
from test_torch_unet import seeded_unet_variables

BASE_C = 4
CROP = 32
AVG_TOL = 1e-7


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
    """JAX checkpoints epoch1 / epoch2 of two seeded UNets and their
    reference-layout copies in a port save dir."""
    base = tmp_path_factory.mktemp("ckpt_tools")
    model = JaxUNet(num_classes=2, base_c=BASE_C)
    optim = make_optimizer(OptimConfig(), warmup_poly_schedule(1e-3, 1, 1))
    jax_dir, port_dir = str(base / "jax"), str(base / "port")
    os.makedirs(port_dir)
    for epoch, seed in ((1, 11), (2, 12)):
        v = seeded_unet_variables(model, 8, seed=seed)
        state = TrainState(params=v["params"], batch_stats=v["batch_stats"],
                           opt_state=optim.init(v["params"]),
                           step=jnp.zeros((), jnp.int32))
        CheckpointManager(jax_dir, "unet").save(
            f"epoch{epoch}", state, epoch=epoch, best_dice=0.1 * epoch)
        jax_migrate.export_to_torch(
            os.path.join(port_dir, f"unet_epoch{epoch}_model.pth"), "unet",
            jax_dir, kind=f"epoch{epoch}")
    return {"base": base, "jax": jax_dir, "port": port_dir}


def _sd(path):
    return torch.load(path, map_location="cpu", weights_only=True)["model"]


def test_average_matches_jax(setup, capsys):
    base = setup["base"]
    jax_out = str(base / "jax_avg")
    jax_average.average_checkpoints("unet", setup["jax"],
                                    ["epoch1", "epoch2"], jax_out)
    want_path = str(base / "jax_avg.pth")
    jax_migrate.export_to_torch(want_path, "unet", jax_out, kind="best")
    path = average.main(["--model", "unet", "--save-dir", setup["port"],
                         "--kinds", "epoch1,epoch2"])
    assert path == os.path.join(setup["port"], "averaged",
                                "unet_best_model.pth")
    want, got = _sd(want_path), _sd(path)
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype, k
        if w.is_floating_point():
            assert (g - w).abs().max() <= AVG_TOL * max(1.0, w.abs().max())
        else:
            assert torch.equal(g, w), k
    raw = torch.load(path, weights_only=True)
    meta = torch.load(want_path, weights_only=True)
    assert raw["epoch"] == meta["epoch"] == 2
    assert raw["best_dice"] == pytest.approx(meta["best_dice"])
    assert json.loads(raw["config"]) == {"averaged_from": ["epoch1",
                                                           "epoch2"]}
    capsys.readouterr()


def test_average_takes_the_ema_copy(setup, tmp_path, capsys):
    """A checkpoint with an EMA copy contributes its EMA weights; the
    integer buffers are the newest checkpoint's."""
    d = str(tmp_path)
    sd1 = _sd(os.path.join(setup["port"], "unet_epoch1_model.pth"))
    sd2 = _sd(os.path.join(setup["port"], "unet_epoch2_model.pth"))
    ema = {k: v * 3.0 for k, v in sd1.items() if k.endswith("weight")}
    newest = {k: (v + 7 if not v.is_floating_point() else v)
              for k, v in sd2.items()}
    torch.save({"model": sd1, "ema": ema, "epoch": 4},
               os.path.join(d, "unet_latest_model.pth"))
    torch.save({"model": newest, "epoch": 9},
               os.path.join(d, "unet_best_model.pth"))
    got = _sd(average.main(["--model", "unet", "--save-dir", d, "--kinds",
                            "latest,best", "--out-dir", d + "/avg"]))
    k = next(iter(ema))
    torch.testing.assert_close(got[k], (ema[k] + sd2[k]) / 2, rtol=0,
                               atol=1e-6)
    for k, v in newest.items():
        if not v.is_floating_point():
            assert torch.equal(got[k], v)
    assert "using EMA weights" in capsys.readouterr().out


def test_migrate_matches_jax_both_ways(setup, monkeypatch, capsys):
    """JAX's migrate initializes a whole train state only to take its
    step counter (0) and its structure; a stand-in with that step spares
    the test the CPU compile of the UNet's init (~35 s). The weights it
    writes are JAX's own conversion of the reference .pth."""
    base = setup["base"]
    monkeypatch.setattr(jax_migrate, "create_train_state",
                        lambda *a, **k: SimpleNamespace(
                            step=jnp.zeros((), jnp.int32)))
    ref = str(base / "reference.pth")
    sd = _sd(os.path.join(setup["port"], "unet_epoch2_model.pth"))
    # the reference's own layout: DataParallel names and its args
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()},
                "epoch": 5, "args": argparse.Namespace(lr=0.01)}, ref)
    common = ["--model", "unet", "--num-classes", "2", "--base-c",
              str(BASE_C)]
    jax_dir, port_dir = str(base / "jax_mig"), str(base / "port_mig")
    jax_migrate.main([ref, "--save-dir", jax_dir, *common])
    out = migrate.main([ref, "--save-dir", port_dir, *common])
    assert out == os.path.join(port_dir, "unet_best_model.pth")
    saved = torch.load(out, weights_only=True)
    assert saved["model"].keys() == sd.keys()  # key for key
    for k, v in sd.items():
        assert torch.equal(saved["model"][k], v), k
    assert (saved["epoch"], saved["best_dice"]) == (5, 0.0)
    assert json.loads(saved["config"]) == {"migrated_from": ref}
    assert saved["optimizer"]["state"] == {}  # a fresh AdamW
    restore_for_inference("unet", out, device="cpu")
    assert "unreadable" not in capsys.readouterr().out

    # --reverse: each package's checkpoint back to the reference layout
    want, got = str(base / "jax_rev.pth"), str(base / "port_rev.pth")
    jax_migrate.main([want, "--reverse", "--save-dir", jax_dir, *common])
    migrate.main([got, "--reverse", "--save-dir", port_dir, *common])
    w, g = (torch.load(p, weights_only=True) for p in (want, got))
    assert g.keys() == w.keys() == {"model", "epoch", "best_dice"}
    assert (g["epoch"], g["best_dice"]) == (w["epoch"], w["best_dice"])
    assert g["model"].keys() == w["model"].keys() == sd.keys()
    for k, v in w["model"].items():
        assert torch.equal(g["model"][k], torch.as_tensor(v)), k
    capsys.readouterr()


def test_export_check_and_symbolic_batch(setup, tmp_path, monkeypatch,
                                         capsys):
    """JAX's export here lowers (and does not compile) a seeded UNet; its
    train-state template is built from the seeded variables directly, as
    in the migrate test."""
    v = seeded_unet_variables(JaxUNet(num_classes=2, base_c=BASE_C), 8, 12)
    monkeypatch.setattr("stf_unet_tpu.train.state.create_train_state",
                        lambda *a, **k: TrainState(
                            params=v["params"], batch_stats=v["batch_stats"],
                            opt_state=None, step=jnp.zeros((), jnp.int32)))
    model_dir = str(tmp_path / "m")
    os.makedirs(model_dir)
    os.link(os.path.join(setup["port"], "unet_epoch2_model.pth"),
            os.path.join(model_dir, "unet_best_model.pth"))
    args = ["--model", "unet", "--base-c", str(BASE_C), "--crop-size",
            str(CROP), "--batch", "0"]
    out = str(tmp_path / "unet.pt2")
    export.main(args + ["--model-dir", model_dir, "--output", out,
                        "--check", "--device", "cpu"])
    assert "roundtrip max|diff|" in capsys.readouterr().out
    jax_out = str(tmp_path / "unet.stablehlo")
    jax_export.main(args + ["--model-dir", setup["jax"], "--output",
                            jax_out, "--allow-random-weights"])
    got = json.load(open(out + ".json"))
    want = json.load(open(jax_out + ".json"))
    assert got.keys() == want.keys()
    for key in ("model", "input", "output_classes", "use_pk_maps",
                "lstm_backend"):
        assert got[key] == want[key], key
    assert got["platforms"] == ["cpu"] and got["bytes"] == os.path.getsize(
        out)
    # the symbolic batch: other sizes through the reloaded artifact
    program = torch.export.load(out).module()
    eager, _, _, _ = restore_for_inference("unet", os.path.join(
        model_dir, "unet_best_model.pth"), dtype="f32", device="cpu")
    fwd = export.build_inference_fn(eager)
    rng = np.random.default_rng(4)
    for b in (1, 3):
        x = torch.from_numpy(rng.normal(size=(b, 8, CROP, CROP, 1))
                             .astype(np.float32))
        with torch.no_grad():
            y = program(x)
            assert y.shape == (b, CROP, CROP, 2)
            assert (y - fwd(x)).abs().max() < export.CHECK_TOL
    with pytest.raises(FileNotFoundError, match="allow-random-weights"):
        export.main(args + ["--model-dir", str(tmp_path / "none"),
                            "--output", str(tmp_path / "x.pt2"),
                            "--device", "cpu"])
