"""The traced tail of a `--trace 1` run: torch.profiler over a fixed
number of steps or batches after the measured window, the first of them
a warm-up whose trace is dropped (the profiler's start-up would read as
idle device time), the rest the traced tail. On a card it records CUDA
activity alone: the profiler's CPU-op recording slows the host's
dispatch severalfold, and the device's idle share would measure the
profiler. (The CPU, in the tests, records CPU activity.)

From the profile: every device operation (kernels, copies, fills) with
its duration, the seconds in which one ran (`busy_s`, the union of their
intervals), the tail's length on the host clock (`window_s`), the device
operations that took most time, and the idle gaps between device work
summed by the innermost host range that covered each gap: the
benchmark's own spans (`portbench.*`), placed on the profile's clock,
and any range the profile recorded itself."""

from __future__ import annotations

import collections
import time
from typing import Callable, Dict, List, Tuple

import torch

TOP = 10
# utils/profiling.annotate ranges of the port's trainer and cli/train
PROGRAM_RANGES = ("train_step", "data_wait", "loss_read", "eval_batch",
                  "eval", "checkpoint")


def short_name(name: str) -> str:
    """A kernel's name without `void`, its template arguments and its
    parameter list."""
    name = name.removeprefix("void ").split("(")[0]
    depth, out = 0, []
    for ch in name:
        depth += ch == "<"
        if depth == 0:
            out.append(ch)
        depth -= ch == ">"
    return "".join(out).strip()


class Tail:
    """with Tail(device, warmup, active, marks) as tail: ..., calling
    tail.step() after each step or batch; tail.summary() after the
    block. `marks()` reads counters, taken over the traced steps."""

    def __init__(self, device: torch.device, warmup: int, active: int,
                 marks: Callable[[], dict] = dict):
        self.device, self.warmup, self.active = device, warmup, active
        self.marks = marks
        self.prof = None
        self.count = 0
        self._t0 = self._t1 = None
        self.counters: Dict[str, int] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, schedule

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities = [ProfilerActivity.CUDA]
        self._sync()
        self.prof = profile(activities=activities, schedule=schedule(
            wait=0, warmup=self.warmup, active=self.active, repeat=1))
        self.prof.__enter__()
        return self

    def step(self) -> None:
        self.count += 1
        if self.count == self.warmup:
            self._sync()
            self._t0, self.start_marks = time.perf_counter(), self.marks()
        if self.count == self.warmup + self.active:
            self._sync()
            self._t1, end = time.perf_counter(), self.marks()
            self.counters = {k: v - self.start_marks[k]
                             for k, v in end.items()}
        self.prof.step()

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        if self._t1 is None:
            raise RuntimeError(f"the traced tail took {self.count} of its "
                               f"{self.warmup} + {self.active} steps")
        return False

    @property
    def seconds(self) -> float:
        return self._t1 - self._t0

    def summary(self, spans=None) -> dict:
        """`spans` (harness/common.Spans): the benchmark's own host spans,
        placed on the profile's clock so that a gap on a thread the
        profiler does not record, as the batcher's worker, still names
        what the host was doing. The traced steps open on an idle device
        (synchronized), so their first device operation starts within
        about a millisecond of the host clock's mark."""
        from torch.autograd import DeviceType

        device_ops: List[Tuple[str, float, float]] = []
        ranges: List[Tuple[float, float, str]] = []
        for e in self.prof.events():
            annotation = (getattr(e, "is_user_annotation", False)
                          or e.name.startswith("portbench.")
                          or e.name in PROGRAM_RANGES)
            if e.device_type == DeviceType.CUDA:
                if not annotation:  # a range's shadow on the GPU timeline
                    device_ops.append((e.name, e.time_range.start,
                                       e.time_range.end))
            elif annotation:
                ranges.append((e.time_range.start, e.time_range.end,
                               e.name))
        zero = min((s for _, s, _ in device_ops), default=0.0)
        for name, t0, t1 in (spans.intervals if spans else ()):
            if t1 >= self._t0:
                ranges.append(((t0 - self._t0) * 1e6 + zero,
                               (t1 - self._t0) * 1e6 + zero,
                               "portbench." + name))
        out = summarize(device_ops, ranges, self.seconds)
        out["counters"] = self.counters
        return out


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(device_ops, ranges, window_s: float) -> dict:
    """device_ops [(name, start_us, end_us)], host ranges [(start_us,
    end_us, name)] -> the tail's summary (seconds throughout)."""
    by_name: Dict[str, float] = collections.defaultdict(float)
    for name, s, e in device_ops:
        by_name[name] += (e - s) * 1e-6
    busy = _merge((s, e) for _, s, e in device_ops)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    ranges = sorted(ranges)
    idle: Dict[str, float] = collections.defaultdict(float)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = (e0 + s1) / 2
        inner = [(re - rs, name) for rs, re, name in ranges
                 if rs <= mid <= re]
        idle[min(inner)[1] if inner else "no host range"] += (s1 - e0) * 1e-6
    short: Dict[str, float] = collections.defaultdict(float)
    for name, sec in by_name.items():
        short[short_name(name)] += sec
    top = sorted(short.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_s, "window_s": window_s,
            "device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in gaps],
            "kernels": by_name}
