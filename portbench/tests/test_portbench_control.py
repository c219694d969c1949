"""On the card, at each cell's own size: the control, the reference
computed one precision below the configuration's bfloat16 (int8,
tools/readings.py) in the program's place, fails at least one of the
cell's limits on three seeds, and the program itself passes them. Skips
where torch sees no CUDA device.

    cd portbench && python -m pytest tests/test_portbench_control.py -m chip
"""

import pytest
import torch

import portbench_tiny  # noqa: F401  (puts the checkout on sys.path)

from portbench.harness import common
from portbench.harness.run import Run
from portbench.harness.spec import Spec
from portbench.reference import nn as rnn
from portbench.tools import readings

SPEC = Spec()
SEEDS = (2**31 + 901, 2**31 + 902, 2**31 + 903)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is read at the cell's "
                    "own size on the H100")
    return torch.device("cuda", 0)


def _fails(numbers: dict, limits: dict) -> bool:
    return not common.passed(common.judge(numbers, limits))


@pytest.mark.chip
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC.bench["workloads"]])
@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_and_program_passes(card, cell, seed):
    run = Run.of(SPEC, cell, seed, 0.0, False, card)
    weights, names, stretches, ref, prog = readings.train_seed(run)
    control = readings.train_control(run, weights, names, stretches, ref,
                                     q=rnn.int8)
    assert not _fails(prog, run.limits), prog
    assert _fails(control, run.limits), control
