"""Arithmetic the per-layer metric readers share (each reader in
portbench/metrics/ picks its own inputs). A reader returns None where
its cell's run gave it nothing to read: no span, no traced tail, a card
with no row in the table of peaks."""

from __future__ import annotations

import importlib
import re
import statistics
from typing import Iterable, Optional

from portbench.arith import kernels, peaks

# The port's kernels as the profiler names them (csrc/*.cu).
K1F = re.compile(r"\blstm_last_x(_tc)?_kernel\b")
K1B = re.compile(r"\blstm_bwd_\w*kernel\b")
K2 = re.compile(r"\bwarp_kernel\b")


def mean_ms(ctx: dict, span: str) -> Optional[float]:
    values = ctx.get("spans", {}).get(span)
    return statistics.fmean(values) * 1e3 if values else None


def idle_pct(ctx: dict) -> Optional[float]:
    tail = ctx.get("tail")
    if not tail or tail["window_s"] <= 0 or tail["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tail["busy_s"] / tail["window_s"])


def kernel_seconds(ctx: dict, patterns: Iterable[re.Pattern]) -> float:
    tail = ctx.get("tail") or {}
    return sum(s for name, s in tail.get("kernels", {}).items()
               if any(p.search(name) for p in patterns))


def forward_flops(ctx: dict, batch: int) -> float:
    run = ctx["run"]
    arith = importlib.import_module(
        f"portbench.arith.models.{run.config['model']}")
    crop = run.traffic["augment"]["crop_size"]
    return arith.forward_flops(run.config["architecture"], batch, crop)


def mfu_pct(ctx: dict, flops: float, seconds: float) -> Optional[float]:
    row = peaks.peak(ctx.get("device_kind", ""))
    if row is None or seconds <= 0 or flops <= 0:
        return None
    return 100.0 * flops / seconds / row["bf16_flops"]


def lstm_bound_s(ctx: dict, batch: int, launches: dict) -> Optional[float]:
    """Least seconds of one step's pixel-LSTM launches at `batch`:
    `launches` {"fwd": K1f, "bwd": K1b} per step, the narrowest scales
    taking them, as the port's routing by width has it."""
    run = ctx["run"]
    arith = importlib.import_module(
        f"portbench.arith.models.{run.config['model']}")
    crop = run.traffic["augment"]["crop_size"]
    lanes = arith.lstm_lanes(run.config["architecture"], batch, crop)
    t = run.config["architecture"]["time_steps"]
    kind = ctx.get("device_kind", "")
    total = 0.0
    for fn, key in ((kernels.lstm_fwd, "fwd"), (kernels.lstm_bwd, "bwd")):
        for c, n in lanes[:launches.get(key, 0)]:
            b = peaks.bound_s(*fn(t, n, c), kind)
            if b is None:
                return None
            total += b[0]
    return total
