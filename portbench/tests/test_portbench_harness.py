"""The harness on the CPU: BENCHMARK.json against the contract's rules,
every cell's files found by name, a cell added by new files alone, the
refusals without a card or without the program, and the result line of
every cell from a run at a small size."""

import hashlib
import json
import re
import shutil
import subprocess
import sys

import pytest

import portbench_tiny

from portbench.harness.spec import Spec

REPO = portbench_tiny.REPO
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_benchmark_json_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(isinstance(w, str) and 1 <= len(w) <= 200
               for w in BENCH["command"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units_use_the_allowed_characters():
    names = []
    for c in BENCH["configs"]:
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        names += [w["name"]]
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert "\n" not in m.get("layer", "") and "\t" not in m.get(
            "layer", "")
    assert all(NAME.match(n) for n in names), names
    assert len(names) == len(set(names))
    for m in BENCH["per_layer"]:
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")


def test_every_cell_finds_its_files():
    spec = Spec(REPO)
    for w in BENCH["workloads"]:
        cfg = spec.config(w["config"])
        traffic = spec.traffic(w["traffic"])
        assert spec.driver(traffic["kind"]).run
        assert spec.limits(w["name"])["numbers"]
        assert cfg["reduced"] == next(
            c["reduced"] for c in BENCH["configs"] if c["name"] == w["config"])
        e2e = [m["name"] for m in spec.metrics(w["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = spec.metrics(w["name"], "per_layer")
        assert layers
        for m in layers:
            assert callable(spec.reader(m["name"]).read)
            assert m["moves"] in e2e


def test_a_cell_is_added_by_new_files_alone(tmp_path):
    root = portbench_tiny.tiny_root(tmp_path)
    before = {p: hashlib.sha256(p.read_bytes()).hexdigest()
              for p in root.rglob("*") if p.is_file()}
    traffic = json.loads((root / "portbench/traffic/train_b16.json")
                         .read_text())
    traffic["batch_size"] = 4
    (root / "portbench/traffic/train_b4.json").write_text(
        json.dumps(traffic))
    shutil.copy(root / "portbench/limits/unet.train.b16.json",
                root / "portbench/limits/unet.train.b4.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "unet.train.b4", "config": "unet", "traffic": "train_b4",
        "chips": 1, "why": "a smaller batch"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "unet.train.b16" in m.get("workloads", []):
            m["workloads"].append("unet.train.b4")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    line = portbench_tiny.run_tiny(root, "unet.train.b4", seconds=1.0)
    assert line["correct"] and line["attempted"] >= 1
    assert set(line["metrics"]) == {"train_slices_per_s", "setup_s"}
    for p, digest in before.items():
        if p.name != "BENCHMARK.json" and "__pycache__" not in str(p):
            assert hashlib.sha256(p.read_bytes()).hexdigest() == digest, p


def test_run_refuses_without_a_card():
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "stflstm.train.b16", "--seed", "3", "--seconds", "1", "--trace",
         "0"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_run_refuses_without_the_program(tmp_path):
    """A checkout of BENCHMARK.json and portbench/ alone: the command
    fails, and past the look for a card the run stops at the port's
    import, printing no result."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    args = ["--workload", "unet.train.b16", "--seed", "3",
            "--seconds", "1", "--trace", "0"]
    proc = subprocess.run([sys.executable, "portbench/run.py", *args],
                          cwd=tmp_path, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    past_the_card = (
        "import torch; from portbench import run; "
        "from portbench.harness.spec import Spec; "
        "run.execute(Spec(), 'unet.train.b16', 3, 1.0, False, "
        "torch.device('cpu'))")
    proc = subprocess.run([sys.executable, "-c", past_the_card],
                          cwd=tmp_path, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "stf_unet_tpu_torch" in proc.stderr


RUN_ALL = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import portbench_tiny, torch
from pathlib import Path
from portbench.harness import common
torch.set_num_threads(2)
root = portbench_tiny.tiny_root(Path(sys.argv[2]))
out = {}
for cell in json.loads((root / "BENCHMARK.json").read_text())["workloads"]:
    for trace in (False, True):
        line = portbench_tiny.run_tiny(root, cell["name"], seconds=1.0,
                                       trace=trace)
        out[f"{cell['name']}/{int(trace)}"] = line
print(json.dumps({"lines": out, "forbidden": common.forbidden_modules()}))
"""


@pytest.fixture(scope="module")
def every_cell(tmp_path_factory):
    """Each cell once untraced and once traced, in a fresh process."""
    proc = subprocess.run(
        [sys.executable, "-c", RUN_ALL, str(REPO / "portbench" / "tests"),
         str(tmp_path_factory.mktemp("cells"))], cwd=REPO,
        capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_no_jax_module_is_loaded(every_cell):
    assert every_cell["forbidden"] == []


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_result_line_keys(every_cell, cell, tmp_path):
    spec = Spec(portbench_tiny.tiny_root(tmp_path))
    plain = every_cell["lines"][f"{cell}/0"]
    traced = every_cell["lines"][f"{cell}/1"]
    assert list(plain) == LINE_KEYS + ["checks"]
    assert list(traced) == LINE_KEYS + ["breakdown", "checks"]
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {
        m["name"] for m in spec.metrics(cell, "end_to_end")}
    assert set(traced["metrics"]) <= {
        m["name"] for m in spec.metrics(cell, "per_layer")}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        plain["device"])
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    for v in plain["checks"].values():
        assert set(v) == {"value", "limit"}
