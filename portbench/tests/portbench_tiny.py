"""A copy of the benchmark at a size the CPU holds, for the tests: the
checkout's BENCHMARK.json and portbench/ copied into a temporary root,
the configurations computing in float32 and the traffic mix cut to a
few slices at crop 32. The drivers and readers run unchanged on it."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_TRAFFIC = {
    "train_b16": {"batch_size": 2, "checked_steps": 3,
                  "profile_warmup_steps": 1, "profile_steps": 2,
                  "print_freq": 1000,
                  "dataset": {"data_seed": 5, "patients": 2,
                              "slices_per_patient": 4, "size": 64,
                              "time_steps": 8},
                  "augment": {"base_size": 64, "crop_size": 32}}
}


def _merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _merge(base[k], v) if isinstance(v, dict) else v
    return out


def tiny_root(tmp: Path) -> Path:
    root = Path(tmp) / "checkout"
    root.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for f in (root / "portbench" / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        cfg["precision"]["compute"] = "float32"
        f.write_text(json.dumps(cfg))
    for name, over in TINY_TRAFFIC.items():
        f = root / "portbench" / "traffic" / f"{name}.json"
        f.write_text(json.dumps(_merge(json.loads(f.read_text()), over)))
    return root


def run_tiny(root: Path, cell: str, seed: int = 2**31 + 11,
             seconds: float = 1.0, trace: bool = False) -> dict:
    """One run of `cell` on the CPU over the small copy at `root`, past
    the harness's look for a card: its result line, parsed."""
    import torch

    from portbench import run
    from portbench.harness.spec import Spec

    line, _ = run.execute(Spec(root), cell, seed, seconds, trace,
                          torch.device("cpu"))
    return json.loads(line)
