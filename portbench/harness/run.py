"""One run of one cell: what a driver is given and what it hands back."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from portbench.harness.spec import Spec


@dataclass
class Run:
    spec: Spec
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device

    @classmethod
    def of(cls, spec: Spec, cell_name: str, seed: int, seconds: float,
           trace: bool, device: torch.device) -> "Run":
        cell = spec.cell(cell_name)
        return cls(spec, cell, spec.config(cell["config"]),
                   spec.traffic(cell["traffic"]), spec.limits(cell_name),
                   int(seed), float(seconds), bool(trace), device)

    @property
    def compute_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[
            self.config["precision"]["compute"]]


@dataclass
class Outcome:
    correct: bool
    attempted: int
    failed: int
    end_to_end: dict             # {metric: value}
    checks: dict                 # {number: {"value", "limit"}}
    memory_peak_bytes: int
    layer_ctx: dict = field(default_factory=dict)  # what the readers read
    tail: Optional[dict] = None  # harness/trace summary of a traced run
