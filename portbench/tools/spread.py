"""The spread of a cell's end-to-end metrics, from which its bounds are
set: `--sets` sets of runs over the same seeds, each run a fresh
`portbench/run.py` process, one after another on this card; then, with
`--traced-seeds`, traced runs.

    python3 portbench/tools/spread.py --workload <cell> \
        --seeds 1,2,3,4,5,6 --sets 2 --seconds 20 [--traced-seeds 7,8,9]

Prints each run's result line (prefixed by set, seed and wall seconds)
and a last summary line: for each metric and set the median and the
spread, the distance between the first and third quartiles of
statistics.quantiles(values, n=4) over the median; `setup_s` leaves out
the first run, which builds the kernels and the training pack in a fresh
checkout."""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

RUN = Path(__file__).resolve().parents[1] / "run.py"


def one(cell: str, seed: int, seconds: float, trace: int,
        log_dir: str = "") -> dict:
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(RUN), "--workload", cell, "--seed", str(seed),
         "--seconds", str(seconds), "--trace", str(trace)],
        capture_output=True, text=True, timeout=1500)
    if log_dir:
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        (Path(log_dir) / f"{cell}.{seed}.{trace}.err").write_text(
            proc.stderr)
    lines = proc.stdout.strip().splitlines()
    out = {"rc": proc.returncode, "wall_s": time.perf_counter() - t0,
           "seed": seed, "trace": trace}
    if proc.returncode == 0 and lines:
        out["line"] = json.loads(lines[-1])
    else:
        out["stderr"] = proc.stderr[-3000:]
    return out


def spread(values):
    q1, _, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return {"median": med, "spread": (q3 - q1) / med, "n": len(values)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--traced-seeds", default="")
    p.add_argument("--log-dir", default="",
                   help="keep each run's standard error here")
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    by_set = []
    first = True
    for k in range(args.sets):
        values = {}
        for seed in seeds:
            r = one(args.workload, seed, args.seconds, 0, args.log_dir)
            print(json.dumps({"set": k, **r}), flush=True)
            line = r.get("line")
            if not line:
                continue
            for name, m in line["metrics"].items():
                if name == "setup_s" and first:
                    continue
                values.setdefault(name, []).append(m["value"])
            first = False
        by_set.append({n: spread(v) for n, v in values.items()
                       if len(v) >= 2})
    for seed in [int(s) for s in args.traced_seeds.split(",") if s]:
        print(json.dumps({"set": "traced",
                          **one(args.workload, seed, args.seconds, 1,
                                args.log_dir)}),
              flush=True)
    print(json.dumps({"summary": by_set}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
