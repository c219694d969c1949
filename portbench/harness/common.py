"""What every driver shares: host spans, the process's start, the card's
description, the ban on the JAX package, and the result's last line."""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
from typing import Dict, List

FORBIDDEN = ("jax", "jaxlib", "flax", "stf_unet_tpu")


class Spans:
    """Host-clock durations by span name, kept in memory."""

    def __init__(self):
        self.seconds: Dict[str, List[float]] = collections.defaultdict(list)
        # (name, start, end) on the host clock, for the traced tail's gaps
        self.intervals: List[tuple] = []

    def add(self, name: str, t0: float, t1: float) -> None:
        self.seconds[name].append(t1 - t0)
        self.intervals.append((name, t0, t1))

    def snapshot(self) -> Dict[str, List[float]]:
        return {k: list(v) for k, v in self.seconds.items()}


def process_age_s() -> float:
    """Seconds since this process started, from /proc (10 ms ticks)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the harness may not hold:
    JAX, its libraries and the JAX package (whole names compared, so the
    port `stf_unet_tpu_torch` is not one of them)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card(device) -> dict:
    """The card's name and power limit (nvidia-smi), printed beside every
    number the run reports."""
    import torch

    out = {"kind": torch.cuda.get_device_name(device)}
    try:
        out["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out["power_limit"] = f"unread ({e})"
    return out


def result_line(*, correct: bool, attempted: int, failed: int,
                metrics: dict, device: dict, checks: dict,
                breakdown: dict = None) -> str:
    """The contract's last line: its keys in order, the compared numbers
    with their limits last."""
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return json.dumps(line)


def check_lines(checks: dict) -> str:
    """Each compared number beside its limit, one per line."""
    return "\n".join(f"check {name}: {v['value']!r} <= {v['limit']!r}"
                     for name, v in checks.items())


def judge(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} of every limited number."""
    return {name: {"value": float(numbers[name]),
                   "limit": float(entry["limit"])}
            for name, entry in limits["numbers"].items()}


def passed(checks: dict) -> bool:
    return all(v["value"] <= v["limit"] for v in checks.values())
