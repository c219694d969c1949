"""A run with the timed path broken underneath comes out with `correct`
false: each fault the cell can have (tools/faults.py), planted in the
program, on the CPU over the small copy of the benchmark, past the
harness's look for a card. The sound run beside them comes out true."""

import pytest
import torch

import portbench_tiny

from portbench.tools import faults

CELLS = {"stflstm.train.b16": faults.TRAINING,
         "unet.train.b16": faults.TRAINING}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return portbench_tiny.tiny_root(tmp_path_factory.mktemp("faults"))


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(root, cell):
    line = portbench_tiny.run_tiny(root, cell)
    assert line["correct"] and line["failed"] == 0
    for name, v in line["checks"].items():
        assert v["value"] <= v["limit"], (name, v)


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(CELLS)
                                        for f in sorted(CELLS[c])])
def test_fault_is_caught(root, cell, fault):
    with CELLS[cell][fault]():
        line = portbench_tiny.run_tiny(root, cell)
    assert not line["correct"], line["checks"]


def _from_step(skip: int):
    """AdamW applies its first `skip` steps, then nothing: a fault that
    only the window's own steps can show (the set-up's steps are sound)."""
    calls = [0]

    def make(inner):
        def step(self, closure=None):
            calls[0] += 1
            return inner(self, closure) if calls[0] <= skip else None
        return step

    return faults._patched(torch.optim.AdamW, "step", make)


@pytest.mark.parametrize("cell", ["stflstm.train.b16", "unet.train.b16"])
def test_a_fault_in_the_window_alone_is_caught(root, cell):
    with _from_step(3):
        line = portbench_tiny.run_tiny(root, cell)
    assert not line["correct"], line["checks"]
