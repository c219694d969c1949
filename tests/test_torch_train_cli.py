"""The port's training entry point (cli/train.py) end to end on the CPU,
on a synthetic BreaDM tree at a small size: epochs, results file,
latest/best checkpoints, resume, the checkpoint's use by the serving path
and by the JAX package's importer, and the flag parser."""

import os

import numpy as np
import pytest
import torch

from stf_unet_tpu.utils.torch_import import load_torch_checkpoint
from stf_unet_tpu_torch.cli import train as train_cli
from stf_unet_tpu_torch.cli.common import restore_for_inference
from stf_unet_tpu_torch.core.config import parse_config
from stf_unet_tpu_torch.data.synthetic import make_synthetic_breadm

FLAGS = ["--device", "cpu", "--data-base-size", "40",
         "--data-crop-size", "32", "--batch-size", "2", "--print-freq", "1"]


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
def run_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    data = str(root / "breadm")
    make_synthetic_breadm(data, size=40, seed=3)
    return data, str(root / "weights"), str(root / "out")


@pytest.fixture(scope="module")
def first_run(run_dirs):
    data, weights, out = run_dirs
    result = train_cli.run(["--data-path", data, "--epochs", "2",
                            "--save-dir", weights, "--output-dir", out,
                            *FLAGS])
    return result


def test_train_cli_writes_results_and_checkpoints(run_dirs, first_run):
    _, weights, _ = run_dirs
    assert [e["epoch"] for e in first_run["epochs"]] == [0, 1]
    assert first_run["steps"] == 4  # 4 training slices, batch 2
    assert all(np.isfinite(e["train_loss"]) for e in first_run["epochs"])
    with open(first_run["results_file"]) as f:
        text = f.read()
    assert "[epoch: 0]" in text and "[epoch: 1]" in text
    assert "dice:" in text and "mean IoU" in text
    for kind in ("latest", "best"):
        path = os.path.join(weights, f"stflstm_{kind}_model.pth")
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        assert set(ckpt) == {"model", "optimizer", "epoch", "step",
                             "best_dice", "config", "seed"}
        assert "final.weight" in ckpt["model"]
    latest = torch.load(os.path.join(weights, "stflstm_latest_model.pth"),
                        weights_only=True)
    assert latest["epoch"] == 1 and latest["step"] == 4
    assert 0.0 <= first_run["test"]["dice"] <= 1.0


def test_train_cli_writes_the_jax_metrics_jsonl(run_dirs, first_run,
                                                tmp_path):
    """The default metrics JSONL: one record per epoch, keyed as the JAX
    trainer's record (its literal keys, the JAX confusion report's mean
    metrics, the writer's "ts"), each line as the JAX JsonlLogger writes
    the same record."""
    import json

    from stf_unet_tpu.metrics.confusion import \
        confusion_report as jax_confusion_report
    from stf_unet_tpu.utils.profiling import JsonlLogger as JaxJsonlLogger

    path = first_run["metrics_file"]
    _, _, out = run_dirs
    assert os.path.dirname(path) == out
    assert os.path.basename(path).startswith("stflstm_metrics_")
    assert path.endswith(".jsonl")
    with open(path) as f:
        records = [json.loads(line) for line in f]
    assert [r["epoch"] for r in records] == [0, 1]
    mean = jax_confusion_report(np.eye(2, dtype=np.int64))["mean_metrics"]
    keys = {"ts", "epoch", "train_loss", "lr", "dice", "global_acc", *mean}
    for r, e in zip(records, first_run["epochs"]):
        assert set(r) == keys
        assert (r["train_loss"], r["lr"], r["dice"]) == (
            e["train_loss"], e["lr"], e["dice"])
    jax_path = str(tmp_path / "jax.jsonl")
    JaxJsonlLogger(jax_path).log({k: v for k, v in records[0].items()
                                  if k != "ts"})
    with open(jax_path) as f:
        jax_record = json.loads(f.read())
    assert set(jax_record) == keys
    assert {k: v for k, v in jax_record.items() if k != "ts"} == {
        k: v for k, v in records[0].items() if k != "ts"}


@pytest.mark.parametrize("flags,results,metrics", [
    ([], True, True),
    (["--jsonl-metrics", "false"], True, False),
    (["--silent"], False, False),
])
def test_train_cli_writers_follow_the_flags(flags, results, metrics,
                                            tmp_path):
    cfg = parse_config(["--output-dir", str(tmp_path), *flags])
    results_file, jsonl = train_cli._writers(cfg, is_main=True)
    assert (results_file is not None, jsonl is not None) == (results,
                                                             metrics)
    assert train_cli._writers(cfg, is_main=False) == (None, None)


def test_resume_continues_at_the_next_epoch(run_dirs, first_run):
    data, weights, out = run_dirs
    result = train_cli.run(["--data-path", data, "--epochs", "3",
                            "--resume", "latest", "--save-dir", weights,
                            "--output-dir", out, *FLAGS])
    assert [e["epoch"] for e in result["epochs"]] == [2]
    assert result["steps"] == 6  # the optimizer step count carried over
    assert result["best_dice"] >= first_run["best_dice"]
    latest = torch.load(os.path.join(weights, "stflstm_latest_model.pth"),
                        weights_only=True)
    assert latest["epoch"] == 2
    assert latest["best_dice"] >= first_run["best_dice"]


def test_best_checkpoint_serves_and_imports(run_dirs, first_run):
    """The best .pth loads in the port's serving path and, as the
    reference's {"model": state_dict} pickle, in the JAX package's
    importer."""
    _, weights, _ = run_dirs
    path = os.path.join(weights, "stflstm_best_model.pth")
    model, data_cfg, model_cfg, meta = restore_for_inference(
        "stflstm", path, crop_size=32, dtype="f32", device="cpu")
    assert not model.training and model_cfg.total_classes == 2
    assert meta["best_dice"] == pytest.approx(first_run["best_dice"])
    with torch.no_grad():
        out = model(torch.zeros((1, 8, 32, 32, 1)))["out"]
    assert out.shape == (1, 32, 32, 2) and torch.isfinite(out).all()
    sd = load_torch_checkpoint(path)
    assert set(sd) == set(model.state_dict())


def test_cuda_default_without_a_gpu_raises(run_dirs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    data, weights, out = run_dirs
    with pytest.raises(RuntimeError, match="cuda"):
        train_cli.run(["--data-path", data, "--epochs", "1",
                       "--save-dir", weights, "--output-dir", out])


def test_parse_config_reference_flags():
    cfg = parse_config(["--data-path", "/d", "--lr", "0.01", "--amp",
                        "--num-classes", "2", "--use-subtraction", "true",
                        "--data-crop-size", "64", "--batch-size", "4",
                        "--device", "cpu", "--workers", "8"])
    assert cfg.data.data_path == "/d" and cfg.optim.lr == 0.01
    assert cfg.amp is True and cfg.model.num_classes == 2
    assert cfg.data.resolved_sequence_types[0] == "SUB1"
    assert cfg.data.crop_size == 64 and cfg.batch_size == 4
    assert cfg.device == "cpu"
    assert parse_config([]).device == "cuda"


# Flags of items ported since they were refused here -> the value they
# parse to; a flag still in UNPORTED_FLAGS stops with its ROADMAP item.
PORTED = {
    "--grad-accum": lambda c: c.grad_accum == 2,
    "--optim-ema-decay": lambda c: c.optim.ema_decay == 0.99,
    "--data-elastic-alpha": lambda c: c.data.elastic_alpha == 4.0,
    "--data-rotation-split": lambda c: c.data.rotation_split is True,
    "--data-pack": lambda c: c.data.pack_dir == "/p",
    "--batch-size": lambda c: c.batch_size == 0,
    "--multihost": lambda c: c.multihost is True,
    "--data-parallel": lambda c: c.data_parallel == 2,
    "--spatial-parallel": lambda c: c.spatial_parallel == 2,
    "--jsonl-metrics": lambda c: c.jsonl_metrics is False,
    "--profile-dir": lambda c: c.profile_dir == "/p",
    "--nan-check": lambda c: c.nan_check is True,
    "--matmul-precision": lambda c: c.matmul_precision == "high",
    "--tf32": lambda c: c.matmul_precision == "tensorfloat32",
    "--aux": lambda c: c.aux is True,
    "--compile-cache-dir": lambda c: c.compile_cache_dir == "/c",
    "--model-remat": lambda c: c.model.remat is True,
}


@pytest.mark.parametrize("argv,item", [
    (["--grad-accum", "2"], "EMA and gradient accumulation"),
    (["--optim-ema-decay", "0.99"], "EMA and gradient accumulation"),
    (["--data-elastic-alpha", "4"], "augmentation extras"),
    (["--data-rotation-split", "true"], "augmentation extras"),
    (["--data-pack", "/p"], "dataset packs"),
    (["--multihost"], "data parallelism"),
    (["--data-parallel", "2"], "data parallelism"),
    (["--spatial-parallel", "2"], "spatial parallelism"),
    (["--batch-size", "auto"], "autobatch"),
    (["--jsonl-metrics", "false"], "long tail"),
    (["--profile-dir", "/p"], "long tail"),
    (["--nan-check"], "long tail"),
    (["--matmul-precision", "high"], "long tail"),
    (["--tf32", "true"], "long tail"),
    (["--aux"], "long tail"),
    (["--compile-cache-dir", "/c"], "long tail"),
    (["--model-remat", "true"], "long tail"),
])
def test_unported_flags_name_their_roadmap_item(argv, item, capsys):
    from stf_unet_tpu_torch.core.config import UNPORTED_FLAGS

    if argv[0] in PORTED:
        assert argv[0] not in UNPORTED_FLAGS
        assert item not in UNPORTED_FLAGS.values()
        assert PORTED[argv[0]](parse_config(argv))
        return
    with pytest.raises(SystemExit):
        parse_config(argv)
    err = capsys.readouterr().err
    assert "ROADMAP.md" in err and item in err
