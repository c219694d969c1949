"""The port's data-parallel entry points, end to end on the CPU:
`cli.train --data-parallel 2 --device cpu` and `cli.test --data-parallel
2` (two spawned gloo ranks each) against one process over the same global
batches, the pattern of the JAX package's tests/test_multihost.py.

One process sees the two ranks' batches concatenated (batch j is rank 0's
batch j, then rank 1's), which is the global batch the ranks assemble.
The runs use the UNet at base_c 4 with EMA and --grad-accum 2, 2 epochs
of 2 micro-steps; the two-rank runs start as subprocesses, two at a time,
waited on with a timeout that kills every process they started.

Tolerances (f32): per-epoch losses within 1e-5 and the final parameters
and EMA within 1e-5 of one process, with AdamW eps 0.1 (at 1e-8, Adam's
m / sqrt(v) turns the f32 round-off of the conv biases before BN, whose
gradients cancel to ~0, into differences of up to an lr; see
tests/test_torch_grad_accum_ema.py); val dice within 1e-6 with equal
confusion matrices; a run stopped by --stop-after-steps inside an
accumulation window and resumed at world 2 bit-equal to the
uninterrupted two-rank run; cli.test's confusion matrix equal and dice
within 1e-6.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from stf_unet_tpu_torch.cli import test as cli_test
from stf_unet_tpu_torch.cli import train as train_cli
from stf_unet_tpu_torch.data.loader import Batch, HostLoader
from stf_unet_tpu_torch.data.synthetic import make_synthetic_breadm
from stf_unet_tpu_torch.core.distributed import free_port
from test_torch_data_parallel import (CLI_RUNNER, SAVE_LOGGER, WORLD,
                                      _env, _wait)

FLAGS = ["--model", "unet", "--model-base-c", "4", "--device", "cpu",
         "--data-base-size", "40", "--data-crop-size", "32",
         "--batch-size", "4", "--epochs", "2", "--grad-accum", "2",
         "--optim-ema-decay", "0.5", "--optim-eps", "0.1",
         "--print-freq", "1"]
STOP = 3  # steps: inside epoch 1's accumulation window


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's small CPU steps: the test
    workers share the host's cores, and torch's default of a thread per
    core makes each tiny op of one worker wait on the others'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def TILED_ARGV(test_argv):
    """cli.test's tiled pass (no --threshold-sweep: it refuses --tiled)."""
    return [a for a in test_argv if a != "--threshold-sweep"] + ["--tiled"]


class MergedLoader:
    """One process over the ranks' global batches: batch j is every
    rank's batch j of a host-sharded HostLoader, in rank order."""

    def __init__(self, index, batch_size, **kw):
        kw.update(drop_last=True, num_hosts=WORLD)
        kw.pop("host_index", None)
        self.parts = [HostLoader(index, batch_size // WORLD, host_index=h,
                                 **kw) for h in range(WORLD)]
        self.canvas = self.parts[0].canvas

    def __len__(self):
        return len(self.parts[0])

    def epoch(self, epoch_num=0, skip_batches=0):
        for parts in zip(*(p.epoch(epoch_num, skip_batches)
                           for p in self.parts)):
            yield Batch(*(np.concatenate([getattr(b, k) for b in parts])
                          for k in ("frames", "masks", "sizes")))


def _one_process_train(argv, monkeypatch):
    def loader(index, batch_size, **kw):
        if kw.get("shuffle"):
            return MergedLoader(index, batch_size, **kw)
        return HostLoader(index, batch_size, **kw)

    with monkeypatch.context() as m:
        m.setattr(train_cli, "HostLoader", loader)
        return train_cli.run(argv)


def _train_argv(root, name, *extra):
    return ["--data-path", os.path.join(root, "tree"), *FLAGS,
            "--save-dir", os.path.join(root, name, "w"),
            "--output-dir", os.path.join(root, name, "o"), *extra]


def _cmd(root, cli, name, argv):
    return [sys.executable, "-c", CLI_RUNNER, cli,
            os.path.join(root, f"{name}.json"), *argv]


def _load(root, name):
    with open(os.path.join(root, f"{name}.json")) as f:
        return json.load(f)


def _ckpt(root, name):
    return torch.load(os.path.join(root, name, "w",
                                   "unet_latest_model.pth"),
                      weights_only=True)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Two-rank runs: "full" (with every checkpoint write logged),
    "stop" (--stop-after-steps) then "resume" (--resume latest), and
    cli.test on "full"'s checkpoints; one --multihost run at world 1
    under torchrun's environment."""
    root = str(tmp_path_factory.mktemp("multihost"))
    tree = os.path.join(root, "tree")
    make_synthetic_breadm(tree, splits=("training",), size=40,
                          patients_per_split=4, seed=1)
    make_synthetic_breadm(tree, splits=("val", "test"), size=40, seed=2)
    logger_dir = os.path.join(root, "logger")
    os.makedirs(logger_dir)
    with open(os.path.join(logger_dir, "sitecustomize.py"), "w") as f:
        f.write(SAVE_LOGGER)
    env = _env(logger_dir)
    env["STF_TEST_SAVE_LOG"] = os.path.join(root, "saves.log")
    dp = ["--data-parallel", str(WORLD)]
    _wait([_cmd(root, "train", "full", _train_argv(root, "full", *dp)),
           _cmd(root, "train", "stop", _train_argv(
               root, "stop", *dp, "--stop-after-steps", str(STOP)))], env)
    stopped = _ckpt(root, "stop")
    test_argv = ["--model", "unet", "--model-dir",
                 os.path.join(root, "full", "w"), "--root", tree,
                 "--device", "cpu", "--per-patient",
                 "--threshold-sweep"]  # at the CLI's batch 1
    torchrun = {"MASTER_ADDR": "localhost", "RANK": "0", "WORLD_SIZE": "1",
                "LOCAL_RANK": "0", "MASTER_PORT": str(free_port())}
    outs = _wait([_cmd(root, "train", "resume", _train_argv(
                      root, "stop", *dp, "--resume", "latest")),
                  _cmd(root, "test", "test", test_argv + [
                      "--output-dir", os.path.join(root, "test_dp"), *dp]),
                  _cmd(root, "train", "multihost", _train_argv(
                      root, "multihost", "--multihost")),
                  _cmd(root, "test", "tiled", TILED_ARGV(test_argv) + [
                      "--output-dir", os.path.join(root, "tiled_dp"),
                      *dp])],
                 {**env, **torchrun})
    return root, stopped, test_argv, outs[2]


def test_two_rank_training_matches_one_process(cli_runs, monkeypatch):
    root = cli_runs[0]
    want = _one_process_train(_train_argv(root, "one"), monkeypatch)
    got = _load(root, "full")
    assert len(got["epochs"]) == len(want["epochs"]) == 2
    assert got["steps"] == want["steps"] == 4
    assert got["batch_size"] == want["batch_size"] == 4
    for g, w in zip(got["epochs"], want["epochs"]):
        assert g["train_loss"] == pytest.approx(w["train_loss"], abs=1e-5)
        assert g["lr"] == w["lr"]
        assert g["dice"] == pytest.approx(w["dice"], abs=1e-6)
    np.testing.assert_array_equal(got["test"]["confusion_matrix"],
                                  want["test"]["confusion_matrix"])
    ours, ref = _ckpt(root, "full"), _ckpt(root, "one")
    for part in ("model", "ema"):
        assert set(ours[part]) == set(ref[part])
        for key, w in ref[part].items():
            np.testing.assert_allclose(ours[part][key].double().numpy(),
                                       w.double().numpy(), rtol=0,
                                       atol=1e-5, err_msg=f"{part} {key}")


def test_one_rank_writes_checkpoints_and_results(cli_runs):
    root = cli_runs[0]
    with open(os.path.join(root, "saves.log")) as f:
        writes = [line.split() for line in f]
    full = [pid for pid, path in writes
            if os.path.join(root, "full") in path]
    assert len(full) >= 3  # latest twice, best at least once
    assert len(set(full)) == 1
    results = [n for n in os.listdir(os.path.join(root, "full", "o"))
               if n.startswith("unet_results_")]
    assert len(results) == 1
    assert len(os.listdir(os.path.join(root, "full", "o",
                                       "test_results"))) == 4


def test_stop_is_agreed_and_resume_is_bit_identical(cli_runs):
    root, stopped = cli_runs[:2]
    stop = _load(root, "stop")
    assert stop["preempted"] is True and stop["steps"] == STOP
    assert (stopped["epoch"], stopped["step_in_epoch"]) == (1, 1)
    assert len(stopped["accum_grads"]) == WORLD  # each rank's window
    resumed, full = _ckpt(root, "stop"), _ckpt(root, "full")
    assert _load(root, "resume")["steps"] == 4
    for part in ("model", "ema"):
        for key, w in full[part].items():
            assert torch.equal(resumed[part][key], w), f"{part} {key}"
    for key, w in full["optimizer"]["state"].items():
        for name, t in w.items():
            assert torch.equal(resumed["optimizer"]["state"][key][name],
                               t), (key, name)


def test_cli_test_two_ranks_match_one_process(cli_runs):
    root, _, test_argv, _ = cli_runs
    want = cli_test.main(test_argv + ["--output-dir",
                                      os.path.join(root, "test_one")])
    got = _load(root, "test")
    np.testing.assert_array_equal(got["confusion_matrix"],
                                  want["confusion_matrix"])
    assert got["dice"] == pytest.approx(want["dice"], abs=1e-6)
    sweep, ref = got["threshold_sweep"], want["threshold_sweep"]
    assert sweep["roc_auc"] == pytest.approx(ref["roc_auc"], abs=1e-6)
    # the ranks' outputs come back in record order: patient by patient
    got_p = got["patient_report"]["patients"]
    want_p = want["patient_report"]["patients"]
    assert sorted(got_p) == sorted(want_p) and len(want_p) == 2
    for pid, w in want_p.items():
        assert got_p[pid]["slices"] == w["slices"]
        assert got_p[pid]["dice"] == pytest.approx(w["dice"], abs=1e-6)
    assert sorted(os.listdir(os.path.join(root, "test_dp"))) == \
        sorted(os.listdir(os.path.join(root, "test_one")))


def test_cli_test_tiled_two_ranks_match_one_process(cli_runs):
    """cli.test --data-parallel 2 --tiled: each rank tiles its records,
    the sums are reduced and rank 0 renders and aggregates every record
    in record order, as one process does."""
    root, _, test_argv, _ = cli_runs
    want = cli_test.main(TILED_ARGV(test_argv) + [
        "--output-dir", os.path.join(root, "tiled_one")])
    got = _load(root, "tiled")
    np.testing.assert_array_equal(got["confusion_matrix"],
                                  want["confusion_matrix"])
    assert got["dice"] == pytest.approx(want["dice"], abs=1e-6)
    got_p = got["patient_report"]["patients"]
    want_p = want["patient_report"]["patients"]
    assert sorted(got_p) == sorted(want_p) and len(want_p) == 2
    for pid, w in want_p.items():
        assert got_p[pid]["slices"] == w["slices"]
        assert got_p[pid]["dice"] == pytest.approx(w["dice"], abs=1e-6)
    one = os.path.join(root, "tiled_one")
    dp = os.path.join(root, "tiled_dp")
    assert sorted(os.listdir(dp)) == sorted(os.listdir(one))
    for name in os.listdir(one):  # the renders, byte for byte
        if name.endswith(".png"):
            with open(os.path.join(one, name), "rb") as a, \
                    open(os.path.join(dp, name), "rb") as b:
                assert a.read() == b.read(), name


def test_multihost_joins_torchruns_group_at_world_one(cli_runs):
    """--multihost under torchrun's environment (world 1, gloo on the
    CPU): the group, DDP and the synced BN engage and the run trains."""
    root, _, _, log = cli_runs
    assert "rank 0 of 1 (gloo)" in log
    run = _load(root, "multihost")
    assert run["steps"] == 4  # 2 epochs of 8 samples at batch 4
    assert all(np.isfinite(e["train_loss"]) for e in run["epochs"])
    assert os.path.isfile(os.path.join(root, "multihost", "w",
                                       "unet_latest_model.pth"))


PK_FLAGS = ["--model", "unet", "--model-base-c", "4", "--device", "cpu",
            "--use-subtraction", "--use-pk-maps", "--generate-pk-maps",
            "--data-base-size", "40", "--data-crop-size", "32",
            "--batch-size", "4", "--epochs", "1", "--print-freq", "1"]


@pytest.fixture(scope="module")
def pk_runs(tmp_path_factory):
    """--generate-pk-maps in a group, each launch on a fresh tree:
    `--data-parallel 2` (the maps fitted before the ranks spawn) and two
    --multihost processes of torchrun's world 2 (rank 0 fits while rank
    1 waits in the long barrier). Returns {launch: (tree, [outputs])}."""
    root = str(tmp_path_factory.mktemp("pk_group"))
    runs, cmds = {}, []
    for launch in ("data_parallel", "multihost"):
        tree = os.path.join(root, launch, "tree")
        make_synthetic_breadm(tree, size=40, sequence_prefix="SUB", seed=3)
        argv = ["--data-path", tree, *PK_FLAGS,
                "--save-dir", os.path.join(root, launch, "w"),
                "--output-dir", os.path.join(root, launch, "o")]
        if launch == "data_parallel":
            cmds.append(_cmd(root, "train", launch,
                             argv + ["--data-parallel", str(WORLD)]))
        else:
            cmds += [_cmd(root, "train", f"{launch}{r}",
                          argv + ["--multihost"]) for r in range(WORLD)]
        runs[launch] = tree
    env, port = _env(), str(free_port())
    outs = _wait(cmds, [env] + [
        {**env, "MASTER_ADDR": "localhost", "MASTER_PORT": port,
         "WORLD_SIZE": str(WORLD), "RANK": str(r), "LOCAL_RANK": str(r)}
        for r in range(WORLD)])
    return root, {"data_parallel": (runs["data_parallel"], outs[:1]),
                  "multihost": (runs["multihost"], outs[1:])}


@pytest.mark.parametrize("launch", ["data_parallel", "multihost"])
def test_generate_pk_maps_under_a_group(pk_runs, launch):
    """The maps are fitted once, before any rank indexes them, and the
    two-rank run trains on them."""
    root, runs = pk_runs
    tree, outs = runs[launch]
    log = "".join(outs)
    assert log.count("Generating PK parameter maps...") == 1
    if launch == "data_parallel":  # fitted before the group started
        assert log.index("PK parameter maps generation completed") < \
            log.index("data parallelism: spawning")
    for split in ("training", "val", "test"):
        for patient in ("P000", "P001"):
            assert os.path.isfile(os.path.join(
                tree, "seg", split, "pk_maps", patient, "ktrans.png"))
    run = _load(root, launch if launch == "data_parallel" else f"{launch}0")
    assert run["steps"] == 1  # 4 records, global batch 4 over 2 ranks
    assert np.isfinite(run["epochs"][0]["train_loss"])
    assert os.path.isfile(os.path.join(root, launch, "w",
                                       "unet_latest_model_pk.pth"))
