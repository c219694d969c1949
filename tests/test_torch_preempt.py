"""Preemption (train/preempt.py) through the port's cli/train on the CPU,
on a tiny synthetic BreaDM tree with the vanilla UNet at base_c = 4: a
run stopped by --stop-after-steps and continued with --resume latest ends
bit-identical (every weight, BN statistic, AdamW moment, EMA weight) to
the same run left alone; once at k = 1, once stopped inside a
--grad-accum 2 window with the EMA and the augmentation extras on (the
save carries the window's gradients; the resumed draws, noise included,
are the ones the uninterrupted run makes). The JAX package's counterpart
is tests/test_preemption.py; tolerance: bit-equal.
"""

import os

import pytest
import torch

from stf_unet_tpu_torch.cli import train as train_cli
from stf_unet_tpu_torch.data.synthetic import make_synthetic_breadm
from stf_unet_tpu_torch.train.preempt import PreemptionGuard

FLAGS = ["--device", "cpu", "--model", "unet", "--model-base-c", "4",
         "--data-base-size", "40", "--data-crop-size", "32",
         "--batch-size", "1", "--epochs", "2", "--print-freq", "100",
         "--silent", "true", "--data-device-prefetch", "1"]
EXTRAS = ["--grad-accum", "2", "--optim-ema-decay", "0.9",
          "--data-elastic-alpha", "3", "--data-elastic-prob", "1",
          "--data-brightness", "0.1", "--data-noise-std", "0.02"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("preempt")
    make_synthetic_breadm(str(root / "breadm"), size=40, seed=3)
    return str(root)


def _run(data, save, *extra):
    return train_cli.run(["--data-path", f"{data}/breadm", "--save-dir",
                          f"{data}/{save}", "--output-dir", f"{data}/out",
                          *FLAGS, *extra])


def _latest(data, save):
    return torch.load(os.path.join(data, save, "unet_latest_model.pth"),
                      weights_only=True)


def _assert_same(a, b):
    for key in ("model", "ema"):
        assert set(a.get(key, {})) == set(b.get(key, {})), key
        for name, t in a.get(key, {}).items():
            assert torch.equal(t, b[key][name]), f"{key}.{name}"
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert set(sa) == set(sb)
    for i in sa:
        for name, t in sa[i].items():
            assert torch.equal(t, sb[i][name]), (i, name)
    assert (a["epoch"], a["step"]) == (b["epoch"], b["step"])


@pytest.mark.parametrize("extra,stop", [([], 3), (EXTRAS, 3)])
def test_stop_and_resume_is_bit_identical(data, extra, stop):
    tag = "k2" if extra else "k1"
    whole = _run(data, f"whole_{tag}", *extra)
    assert whole["steps"] == 8 and "preempted" not in whole
    stopped = _run(data, f"cut_{tag}", *extra, "--stop-after-steps",
                   str(stop))
    assert stopped["preempted"] and stopped["steps"] == stop
    cut = _latest(data, f"cut_{tag}")
    assert (cut["epoch"], cut["step_in_epoch"]) == (0, stop)
    # inside a --grad-accum 2 window the save carries its gradients
    assert ("accum_grads" in cut) == bool(extra)
    assert ("ema" in cut) == bool(extra)
    resumed = _run(data, f"cut_{tag}", *extra, "--resume", "latest")
    assert resumed["steps"] == 8
    assert [e["epoch"] for e in resumed["epochs"]] == [0, 1]
    _assert_same(_latest(data, f"cut_{tag}"), _latest(data, f"whole_{tag}"))
    assert resumed["test"]["dice"] == whole["test"]["dice"]


def test_guard_counts_steps_and_signals():
    guard = PreemptionGuard(stop_after_steps=2)
    try:
        assert not guard.should_stop() and not guard.triggered
        assert guard.should_stop() and guard.triggered
    finally:
        guard.uninstall()
    guard = PreemptionGuard()
    try:
        assert not guard.should_stop()
        guard._handle(15, None)  # SIGTERM
        assert guard.should_stop(increment=False)
    finally:
        guard.uninstall()
