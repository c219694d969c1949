"""The benchmark as data: BENCHMARK.json at the checkout's root names the
cells, and each cell's configuration, traffic mix, limits and per-layer
metric readers are files found by name under portbench/:

  configs/<config>.json     the model configuration (BENCHMARK.json's
                            `file` of the configuration);
  traffic/<mix>.json        the traffic mix; its `kind` picks the driver
                            drivers/<kind>.py;
  limits/<cell>.json        the limits of the numbers that decide
                            `correct` in that cell;
  metrics/<metric>.py       a per-layer metric's reader, `read(ctx)`.

A cell, a mix or a metric is added by adding files and an entry; no
existing file changes."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import List, Optional

ROOT = Path(__file__).resolve().parents[2]


class Spec:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self.home = self.root / "portbench"

    def cell(self, name: str) -> dict:
        for cell in self.bench["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (cells: "
                       f"{[c['name'] for c in self.bench['workloads']]})")

    def config(self, name: str) -> dict:
        for entry in self.bench["configs"]:
            if entry["name"] == name:
                return json.loads((self.root / entry["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.home / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        return json.loads((self.home / "limits" / f"{cell}.json").read_text())

    def driver(self, kind: str):
        if not (self.home / "drivers" / f"{kind}.py").is_file():
            raise KeyError(f"no driver portbench/drivers/{kind}.py")
        return importlib.import_module(f"portbench.drivers.{kind}")

    def metrics(self, cell: str, section: str) -> List[dict]:
        """The `section` ("end_to_end" or "per_layer") metrics that `cell`
        reports: those that list it, and those with no list."""
        return [m for m in self.bench[section]
                if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        path = self.home / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module


def read_per_layer(spec: Spec, cell: str, ctx: dict) -> dict:
    """{metric: {"value", "unit"}} of every per-layer metric of the cell
    whose reader finds something to read (a reader that returns None is
    left out of the line)."""
    out = {}
    for m in spec.metrics(cell, "per_layer"):
        value: Optional[float] = spec.reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
