"""portbench/tools/phases.py on the CPU: the program's spans name the
idle gaps by the trainer's thread alone, an annotation's shadow on the
device is no operation, the readings are None without spans, and a run
of each cell at a small size reads all six phases."""

import json

import pytest
import torch

import portbench_tiny

from portbench.harness.spec import Spec
from portbench.tools import phases

BENCH = json.loads((portbench_tiny.REPO / "BENCHMARK.json").read_text())


class FakeSpan:
    def __init__(self, name, start_us, end_us, thread, step=(0, 0)):
        self.name, self.thread, self.step = name, thread, step
        self.start_ns, self.end_ns = int(start_us * 1e3), int(end_us * 1e3)


def test_a_gap_goes_to_the_trainers_innermost_span():
    spans = [FakeSpan("train_step", 0, 100, thread=1),
             FakeSpan("forward", 10, 60, thread=1),
             # shorter, over the same gap, but on the loader's thread
             FakeSpan("loader", 20, 30, thread=2)]
    ops = [("k", 0, 10), ("k", 40, 45), ("k", 200, 210)]
    out = phases.name_gaps(ops, phases.program_ranges(spans, 0),
                           [(0, 150, "portbench.train_step")])
    got = dict(out["idle_gaps"])
    assert got == pytest.approx({"forward": 30e-6, phases.NO_RANGE: 155e-6})
    assert out["by_bench_span"]["portbench.train_step"] == pytest.approx(
        {"forward": 30e-6, phases.NO_RANGE: 155e-6})
    assert out["unnamed_between"] == pytest.approx({"train_step>": 155e-6})


class FakeEvent:
    def __init__(self, name, device_type, flagged=False):
        from torch.autograd import DeviceType

        self.name = name
        self.device_type = getattr(DeviceType, device_type)
        self.is_user_annotation = flagged
        self.time_range = type("R", (), {"start": 1.0, "end": 2.0})()


@pytest.mark.parametrize("name", phases.SPAN_NAMES)
def test_a_span_shadow_on_the_device_is_no_operation(name):
    ops, shadows = phases.device_ops([FakeEvent(name, "CUDA"),
                                      FakeEvent("gemm", "CUDA"),
                                      FakeEvent("aten::mm", "CPU")])
    assert [op[0] for op in ops] == ["gemm"]
    assert shadows == [(name, False)]


def test_the_readings_are_none_without_spans():
    got = phases.phase_ms([], {(0, 3)})
    assert set(got) == set(phases.PHASE_METRICS) | {"train_step_ms"}
    assert all(v is None for v in got.values())
    assert phases.covered(got) is None
    assert phases.name_gaps([], [])["idle_gaps"] == []


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_small_run_reads_every_phase(cell, tmp_path):
    torch.set_num_threads(2)
    root = portbench_tiny.tiny_root(tmp_path)
    out = phases.run_cell(Spec(root), cell, 2**31 + 17, 1.0, True,
                          torch.device("cpu"))
    assert out["correct"] and out["attempted"] >= 1
    assert all(out["phases"][m] > 0 for m in phases.PHASE_METRICS), out
    assert 0.5 < out["covered"] <= 1.0
    assert set(out["between_ms"]) <= {"data_wait>train_step",
                                      "train_step>loss_read",
                                      "loss_read>data_wait",
                                      "train_step>data_wait",
                                      "loss_read>loss_read"}
    assert out["tail"]["idle_gaps"] == []  # no device on the CPU
