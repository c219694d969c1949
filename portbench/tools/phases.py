"""The port's own spans in a run of a training cell: the run as
`portbench/run.py` makes it, inside the program's span recorder
(stf_unet_tpu_torch.utils.profiling.record_spans), and what the spans
show.

    python3 portbench/tools/phases.py --workload <cell> --seed <n> \
        --seconds 51 --trace <0|1>

Prints one JSON line: the run's result (`correct`, `attempted`, its
metrics), `phases`, the mean host ms per window step of each span the
trainer opens (train/loop: data_wait, augment, forward, backward,
optimizer, loss_read, and train_step), and `covered`, the share of
train_step that its four phases cover, and `between_ms`, the host ms
per window step that the trainer's thread spends outside its top-level
spans, by the spans on either side. With --trace 1 also `tail`:

  * `idle_gaps`: the traced steps' idle device time by the innermost
    span of the trainer's thread open over each gap, the spans placed on
    the profile by their time.time_ns() stamps at their offset from the
    trace's trace_start_ns() (one clock), "no host range" where none is,
    and `unnamed_between` the latter by the spans on either side;
  * `by_bench_span`: the same gaps, first by the benchmark's own spans
    placed as harness/trace places them (the tail's first host mark at
    its first device operation), then by the program's;
  * `clock_offset_us`: how far the first device operation starts after
    that host mark on the shared clock, which the benchmark takes as 0;
  * `device_annotations`: device-timeline events named as a program
    span, with whether torch flags them as user annotations.

The benchmark runs these cells with the recorder off (run.py). Comparing
--trace 0 runs of the two gives the recorder's cost."""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import sys
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.harness import trace as trace_lib  # noqa: E402

# metric name -> the trainer's span (train/loop.py)
PHASE_METRICS = {"data_wait_ms.train": "data_wait",
                 "augment_host_ms.train": "augment",
                 "fwd_host_ms.train": "forward",
                 "bwd_host_ms.train": "backward",
                 "optim_host_ms.train": "optimizer",
                 "loss_read_ms.train": "loss_read"}
PHASES = ("augment", "forward", "backward", "optimizer")
SPAN_NAMES = tuple(PHASE_METRICS.values()) + ("train_step",)
NO_RANGE = "no host range"


def window_steps(spans, checked: int, attempted: int) -> Set[tuple]:
    """The step ids of the window's steps: the train_step spans after the
    run's `checked` set-up steps, `attempted` of them."""
    steps = [s.step for s in spans if s.name == "train_step"]
    return set(steps[checked:checked + attempted])


def phase_ms(spans, window: Set[tuple]) -> Dict[str, Optional[float]]:
    """Mean host ms per window step of each trainer span (None where the
    window has none)."""
    total: Dict[str, float] = collections.defaultdict(float)
    for s in spans:
        if s.step in window and s.end_ns is not None:
            total[s.name] += (s.end_ns - s.start_ns) / 1e6
    out = {metric: (total[name] / len(window) if total.get(name) else None)
           for metric, name in PHASE_METRICS.items()}
    out["train_step_ms"] = (total["train_step"] / len(window)
                            if total.get("train_step") else None)
    return out


def covered(phases: Dict[str, Optional[float]]) -> Optional[float]:
    """Share of train_step that augment, forward, backward and optimizer
    cover."""
    parts = [phases[m] for m, n in PHASE_METRICS.items() if n in PHASES]
    if phases["train_step_ms"] is None or None in parts:
        return None
    return sum(parts) / phases["train_step_ms"]


def between_ms(spans, window: Set[tuple]) -> Dict[str, float]:
    """Host ms per window step that the trainer's thread spends outside
    its top-level spans, by the spans on either side ("loss_read>
    data_wait": after a loss read, before the next batch wait)."""
    threads = {s.thread for s in spans if s.name == "train_step"}
    top = sorted((s for s in spans if s.thread in threads
                  and s.parent is None and s.end_ns is not None),
                 key=lambda s: s.start_ns)
    out: Dict[str, float] = collections.defaultdict(float)
    for a, b in zip(top, top[1:]):
        if a.step in window and b.step in window:
            out[f"{a.name}>{b.name}"] += (b.start_ns - a.end_ns) / 1e6
    return {k: v / len(window) for k, v in out.items()} if window else {}


def device_ops(events) -> Tuple[list, list]:
    """(device operations [(name, start_us, end_us)], device-timeline
    events named as a program span [(name, is_user_annotation)]) of a
    profile's events: an annotation's shadow on the device is no
    operation."""
    from torch.autograd import DeviceType

    ops, shadows = [], []
    for e in events:
        if e.device_type != DeviceType.CUDA:
            continue
        flagged = bool(getattr(e, "is_user_annotation", False))
        if e.name in SPAN_NAMES or e.name in trace_lib.PROGRAM_RANGES:
            shadows.append((e.name, flagged))
        elif not (flagged or e.name.startswith("portbench.")):
            ops.append((e.name, e.time_range.start, e.time_range.end))
    return ops, shadows


def idle_gaps(ops) -> List[Tuple[float, float]]:
    """The gaps between the device's busy intervals, in us."""
    busy = trace_lib._merge((s, e) for _, s, e in ops)
    return [(e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:])]


def innermost(ranges: Iterable[tuple], t: float) -> str:
    inner = [(e - s, name) for s, e, name in ranges if s <= t <= e]
    return min(inner)[1] if inner else NO_RANGE


def bracket(ranges: Iterable[tuple], t: float) -> str:
    """"a>b": the last range to end before t and the first to start
    after it."""
    before = max(((e, n) for s, e, n in ranges if e < t), default=(0, ""))
    after = min(((s, n) for s, e, n in ranges if s > t), default=(0, ""))
    return f"{before[1]}>{after[1]}"


def program_ranges(spans, start_ns: int) -> List[tuple]:
    """The spans of the thread that runs train_one_epoch (the thread of
    its train_step spans) as (start_us, end_us, name) on a profile that
    began at `start_ns`."""
    threads = {s.thread for s in spans if s.name == "train_step"}
    return [((s.start_ns - start_ns) / 1e3, (s.end_ns - start_ns) / 1e3,
             s.name) for s in spans
            if s.thread in threads and s.end_ns is not None]


def name_gaps(ops, ranges, bench_ranges=()) -> dict:
    """Idle seconds by the innermost program range over each gap's
    middle, and by (benchmark range, program range)."""
    by_name: Dict[str, float] = collections.defaultdict(float)
    unnamed: Dict[str, float] = collections.defaultdict(float)
    cross: Dict[str, Dict[str, float]] = collections.defaultdict(
        lambda: collections.defaultdict(float))
    for e0, s1 in idle_gaps(ops):
        mid, sec = (e0 + s1) / 2, (s1 - e0) * 1e-6
        name = innermost(ranges, mid)
        by_name[name] += sec
        cross[innermost(bench_ranges, mid)][name] += sec
        if name == NO_RANGE:
            unnamed[bracket(ranges, mid)] += sec
    return {"idle_gaps": sorted(by_name.items(), key=lambda kv: -kv[1]),
            "unnamed_between": dict(unnamed),
            "by_bench_span": {k: dict(v) for k, v in cross.items()}}


def tail_view(tail, bench_spans, stamp: Tuple[float, int], spans) -> dict:
    """The traced tail seen through the program's spans. `stamp` is a
    (perf_counter, time_ns) pair read together just after the tail, which
    maps the tail's host marks to the shared clock."""
    start_ns = tail.prof.profiler.kineto_results.trace_start_ns()
    ops, shadows = device_ops(tail.prof.events())
    if not ops:
        return {"idle_gaps": [], "unnamed_between": {}, "by_bench_span": {},
                "clock_offset_us": None,
                "device_annotations": sorted(set(shadows))}
    zero = min(s for _, s, _ in ops)
    mark_us = (stamp[1] - (stamp[0] - tail._t0) * 1e9 - start_ns) / 1e3
    bench = [((t0 - tail._t0) * 1e6 + zero, (t1 - tail._t0) * 1e6 + zero,
              "portbench." + name)
             for name, t0, t1 in (bench_spans.intervals if bench_spans
                                  else ()) if t1 >= tail._t0]
    out = name_gaps(ops, program_ranges(spans, start_ns), bench)
    out["clock_offset_us"] = zero - mark_us
    out["device_annotations"] = sorted(set(shadows))
    return out


def run_cell(spec, cell: str, seed: int, seconds: float, trace: bool,
             device) -> dict:
    """One run of `cell` with the recorder on: the result line's numbers
    and the spans' view of it."""
    from stf_unet_tpu_torch.utils import profiling

    from portbench import run as bench_run

    tails = []
    summary = trace_lib.Tail.summary

    def keep(self, spans=None):
        tails.append((self, spans, (time.perf_counter(), time.time_ns())))
        return summary(self, spans)

    trace_lib.Tail.summary = keep
    try:
        with profiling.record_spans() as rec, \
                contextlib.redirect_stdout(sys.stderr):
            line, _ = bench_run.execute(spec, cell, seed, seconds, trace,
                                        device)
    finally:
        trace_lib.Tail.summary = summary
    result = json.loads(line)
    traffic = spec.traffic(spec.cell(cell)["traffic"])
    window = window_steps(rec.spans, traffic["checked_steps"],
                          result["attempted"])
    phases = phase_ms(rec.spans, window)
    out = {"workload": cell, "seed": seed, "trace": int(trace),
           "correct": result["correct"], "attempted": result["attempted"],
           "metrics": {k: v["value"] for k, v in result["metrics"].items()},
           "phases": phases, "covered": covered(phases),
           "between_ms": between_ms(rec.spans, window)}
    if trace and tails:
        tail, bench_spans, stamp = tails[0]
        out["device"] = {k: result["device"][k]
                         for k in ("busy_s", "window_s")}
        out["bench_idle_gaps"] = result["breakdown"]["idle_gaps"]
        out["tail"] = tail_view(tail, bench_spans, stamp, rec.spans)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    import torch

    from portbench.harness.spec import Spec

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 2
    out = run_cell(Spec(), args.workload, args.seed, args.seconds,
                   bool(args.trace), torch.device("cuda", 0))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
