"""The readings the limits of `correct` are set from, for one cell, over
many seeds in one process (the set-up paid once):

  sound    the program as the configuration states it, compared with the
           float32 reference, exactly as a benchmark run compares it (the
           run's first steps, the window's first steps and the first of
           its next epoch);
  control  one precision below the configuration's bfloat16: the
           reference with every activation and its gradient in symmetric
           per-tensor int8 (reference/nn.int8) in the program's place
           (the port has no int8 training path of its own);
  fp8      (beside the control) the reference in float8 (reference/nn.fp8)
           in the program's place;
  faults   tools/faults.py's faults the cell can have, planted in the
           program;
  witness  the plain reference computed in the configuration's
           own bfloat16 against the float32 one: where the program and
           it read alike, the gap is the precision's, not the program's.

    python3 portbench/tools/readings.py --workload <cell> \
        --seeds 11,12,13 [--control-seeds 11,12,13] [--witness-seeds 11]

Prints one JSON line per seed and reading, then a summary line: for each
number the largest sound reading (the lower one), the smallest control
reading and each fault's smallest reading. Runs on a CUDA card, or with
--device cpu on the CPU (the tests' small copy)."""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from portbench.harness import common  # noqa: E402
from portbench.harness.run import Run  # noqa: E402
from portbench.harness.spec import Spec  # noqa: E402
from portbench.reference import nn as rnn  # noqa: E402
from portbench.tools import faults  # noqa: E402


def _free(dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def train_seed(run: Run, fault=None):
    """The program's checked steps (under `fault`) against the float32
    reference: (weights, trainable names, the stretches, the reference's
    readings, the program's numbers)."""
    from portbench.drivers import train_loop

    tr = run.traffic
    with fault() if fault else contextlib.nullcontext():
        stepper, weights, names = train_loop._build(run, common.Spans())
        first = train_loop._first_steps(stepper, weights,
                                        tr["checked_steps"])
        probes = train_loop.window_probes(stepper,
                                          tr["checked_window_steps"])
        train_loop.window(stepper, probes, lambda: True)
        stretches = [first] + [p.stretch() for p in probes]
    del stepper, probes
    _free(run.device)
    ref = train_loop.reference(run, weights, names, stretches)
    return (weights, names, stretches, ref,
            train_loop.judge_stretches(stretches, ref))


def train_control(run: Run, weights, names, stretches, ref, q=rnn.int8,
                  cast=None):
    """The reference under `q` (or, as a witness, with its forward cast to
    `cast`) in the program's place, against the float32 reference."""
    from portbench.drivers import train_loop
    from portbench.reference.compare import combine, train_numbers

    low = train_loop.reference(run, weights, names, stretches, q=q,
                               cast=cast)
    return combine([train_numbers(lo[0], r[0], lo[1], r[1], lo[2], r[2],
                                  ref[0][0][0]) for lo, r in zip(low, ref)])


def parse_seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--witness-seeds", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(f"card: {common.card(dev)}", file=sys.stderr)
    spec = Spec()
    control_seeds = set(parse_seeds(args.control_seeds))
    fault_seeds = set(parse_seeds(args.fault_seeds))
    witness_seeds = set(parse_seeds(args.witness_seeds))
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    for seed in parse_seeds(args.seeds):
        run = Run.of(spec, args.workload, seed, 0.0, False, dev)
        weights, names, stretches, ref, prog = train_seed(run)
        emit({"seed": seed, "reading": "sound", **prog})
        if seed in control_seeds:
            for name, q in (("control_int8", rnn.int8), ("fp8", rnn.fp8)):
                emit({"seed": seed, "reading": name,
                      **train_control(run, weights, names, stretches, ref,
                                      q=q)})
        if seed in witness_seeds:
            emit({"seed": seed, "reading": "witness_bf16",
                  **train_control(run, weights, names, stretches, ref,
                                  q=None, cast=torch.bfloat16)})
        for name, fault in faults.TRAINING.items():
            if seed in fault_seeds:
                emit({"seed": seed, "reading": name,
                      **train_seed(run, fault)[4]})
        del weights, stretches, ref
        _free(dev)
    summary = {}
    for row in rows:
        for k, v in row.items():
            if k in ("loss_gap", "loss_gap_first", "grad_gap",
                     "grad_gap_median", "grad_err_median", "grad_err",
                     "update_gap"):
                key = (k, row["reading"])
                op = max if row["reading"] == "sound" else min
                summary[key] = op(summary.get(key, v), v)
    print(json.dumps({"summary": {f"{k}/{r}": v
                                  for (k, r), v in sorted(summary.items())}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
