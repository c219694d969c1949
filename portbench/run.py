"""Run one cell of the benchmark once on the card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds BENCHMARK.json and the PyTorch
port (stf_unet_tpu_torch). The cell's traffic mix names its driver
(portbench/drivers/<kind>.py), which sets up, warms up, measures for
--seconds and then checks what the timed path produced against the plain
reference. The last line of standard output is the result: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), `device`, with --trace 1 `breakdown`, and
last `checks`, each compared number beside its limit, which also end
standard error. Everything else the run prints goes to standard error.

Exits 2 without printing a result where torch sees no CUDA device or
fewer than the cell asks for, and 3 where a module of JAX or of the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness import common  # noqa: E402
from portbench.harness.spec import Spec, read_per_layer  # noqa: E402


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def execute(spec: Spec, cell: str, seed: int, seconds: float, trace: bool,
            device):
    """The rest of a run once a device is chosen: the driver, then
    (the result's line, the compared numbers)."""
    import torch

    from portbench.harness.run import Run

    run = Run.of(spec, cell, seed, seconds, trace, device)
    out = spec.driver(run.traffic["kind"]).run(run)
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": torch.cuda.get_device_name(device)
            if device.type == "cuda" else "cpu",
            "count": int(run.cell["chips"]),
            "memory_peak_bytes": int(out.memory_peak_bytes)}
    breakdown = None
    if trace:
        ctx = dict(out.layer_ctx, device_kind=info["kind"])
        metrics = read_per_layer(spec, cell, ctx)
        info["busy_s"] = out.tail["busy_s"]
        info["window_s"] = out.tail["window_s"]
        breakdown = {"device_ops": out.tail["device_ops"],
                     "idle_gaps": out.tail["idle_gaps"]}
    else:
        units = {m["name"]: m["unit"] for m in spec.metrics(cell,
                                                            "end_to_end")}
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in out.end_to_end.items() if k in units}
    return common.result_line(
        correct=out.correct, attempted=out.attempted, failed=out.failed,
        metrics=metrics, device=info, checks=out.checks,
        breakdown=breakdown), out.checks


def main(argv=None) -> int:
    args = parse_args(argv)
    spec = Spec()
    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"error: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " (no CPU fallback)", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(f"card: {common.card(device)}", file=sys.stderr)
    with contextlib.redirect_stdout(sys.stderr):
        line, checks = execute(spec, args.workload, args.seed, args.seconds,
                               bool(args.trace), device)
    banned = common.forbidden_modules()
    if banned:
        print(f"error: modules of JAX or the JAX package loaded: {banned}",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(line, flush=True)
    print(common.check_lines(checks), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
