"""The benchmark's frozen arithmetic: FLOP counts from the published
shapes and the kernels' bounds, against the program's own counts and the
bounds PERF.md records."""

import json

import pytest

import portbench_tiny

from portbench.arith import kernels, peaks
from portbench.arith.models import stflstm, unet

H100 = "NVIDIA H100 80GB HBM3"


def _arch(name):
    return json.loads((portbench_tiny.REPO / "portbench" / "configs"
                       / f"{name}.json").read_text())["architecture"]


def test_unet_step_flops():
    assert 3 * unet.forward_flops(_arch("unet"), 16, 224) == 3554483896320


@pytest.mark.parametrize("batch,crop", [(16, 224), (3, 96), (1, 32)])
def test_flops_match_the_programs_count(batch, crop):
    from stf_unet_tpu_torch.core.config import ModelConfig
    from stf_unet_tpu_torch.utils.benchkit import step_flops

    assert 3 * stflstm.forward_flops(_arch("stflstm"), batch, crop) == \
        step_flops(ModelConfig(model="stflstm"), batch, crop)
    assert 3 * unet.forward_flops(_arch("unet"), batch, crop) == \
        step_flops(ModelConfig(model="unet"), batch, crop)


def _ms(parts):
    return sum(peaks.bound_s(f, b, H100)[0] for f, b in parts) * 1e3


def test_kernel_bounds_match_the_recorded_ones():
    lanes8 = stflstm.lstm_lanes(_arch("stflstm"), 8, 224)
    lanes16 = stflstm.lstm_lanes(_arch("stflstm"), 16, 224)
    assert [c for c, _ in lanes8] == [64, 128, 256, 512]
    k1f = _ms([kernels.lstm_fwd(8, n, c) for c, n in lanes8[:3]])
    k1b = _ms([kernels.lstm_bwd(8, n, c) for c, n in lanes16[:2]])
    k3 = _ms([kernels.lstm_last(8, n, c) for c, n in lanes8[3:]])
    k2 = _ms([kernels.warp(16, 9, 256, 256, 224, 224)])
    assert round(k1f, 4) == 0.0399
    assert round(k1b, 3) == 0.160
    assert round(k2, 4) == 0.0134
    assert round(k3, 5) == 0.00665


def test_unknown_card_has_no_peak():
    assert peaks.bound_s(1.0, 1.0, "some other card") is None
