"""The port's --batch-size auto (train/autobatch.py) held against the JAX
package's pick_batch_size: given the same two probe measurements (step
bytes at batches 2 and 4, state bytes) and budget, both pick the same
batch, or both refuse. On the CPU, where the allocator reports nothing,
cli/train's auto raises. Exact integer equality; no tolerance.
"""

import pytest
import torch

import stf_unet_tpu.train.autobatch as jax_autobatch
from stf_unet_tpu.core.config import TrainConfig as JaxTrainConfig
from stf_unet_tpu_torch.cli import train as train_cli
from stf_unet_tpu_torch.core.config import TrainConfig
from stf_unet_tpu_torch.data.synthetic import make_synthetic_breadm
from stf_unet_tpu_torch.train.autobatch import pick_batch_size

GIB = 2 ** 30
MIB = 2 ** 20


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's small CPU steps: the test
    workers share the host's cores, and torch's default of a thread per
    core makes each tiny op of one worker wait on the others'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _linear(per_sample, fixed, state):
    return lambda batch: (int(fixed + per_sample * batch), int(state))


@pytest.mark.parametrize("per_sample,fixed,state,budget", [
    (205 * MIB, 1.1 * GIB, 0.4 * GIB, 80 * GIB),   # ~ the full-width step
    (205 * MIB, 1.1 * GIB, 0.4 * GIB, 16 * GIB),
    (3 * MIB, 0.01 * GIB, 0.002 * GIB, 80 * GIB),  # hits the 1024 cap
    (700 * MIB, 2 * GIB, 1 * GIB, 5 * GIB),        # batch 2
    (1.5 * GIB, 0.5 * GIB, 0.3 * GIB, 2.6 * GIB),  # batch 1
])
def test_pick_matches_jax(per_sample, fixed, state, budget, monkeypatch):
    measure = _linear(per_sample, fixed, state)
    monkeypatch.setattr(jax_autobatch, "measure_step_memory",
                        lambda cfg, t, b, canvas=None: measure(b))
    want = jax_autobatch.pick_batch_size(JaxTrainConfig(), 8,
                                         budget_bytes=int(budget))
    got = pick_batch_size(TrainConfig(), 8, budget_bytes=int(budget),
                          measure=measure)
    assert got == want
    assert got & (got - 1) == 0 and 1 <= got <= 1024


@pytest.mark.parametrize("measure", [_linear(4 * GIB, 1 * GIB, 1 * GIB),
                                     _linear(0, 1 * GIB, 0)])
def test_refusals_match_jax(measure, monkeypatch):
    monkeypatch.setattr(jax_autobatch, "measure_step_memory",
                        lambda cfg, t, b, canvas=None: measure(b))
    with pytest.raises(RuntimeError) as jax_err:
        jax_autobatch.pick_batch_size(JaxTrainConfig(), 8,
                                      budget_bytes=2 * GIB)
    with pytest.raises(RuntimeError) as err:
        pick_batch_size(TrainConfig(), 8, budget_bytes=2 * GIB,
                        measure=measure)
    for reason in ("degenerate", "even batch 1 does not fit"):
        assert (reason in str(err.value)) == (reason in str(jax_err.value))


@pytest.mark.parametrize("budget", [[], ["--auto-batch-budget-gb", "1"]])
def test_auto_raises_on_the_cpu(tmp_path, budget):
    data = str(tmp_path / "breadm")
    make_synthetic_breadm(data, size=40, seed=3, splits=("training", "val"))
    with pytest.raises(RuntimeError, match="explicit --batch-size"):
        train_cli.run(["--data-path", data, "--device", "cpu",
                       "--batch-size", "auto", "--model", "unet",
                       "--save-dir", str(tmp_path / "w"), "--silent",
                       "true", *budget])
