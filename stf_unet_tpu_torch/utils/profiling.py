"""Profiling, the NaN check and structured metrics (counterpart of
stf_unet_tpu/utils/profiling.py).

  * `trace(log_dir)`: a torch.profiler session over CPU and CUDA activity
    that writes a Chrome / Perfetto trace, `log_dir/trace_rank<r>.json`
    (one file per rank under data parallelism); cli/train --profile-dir
    traces the first epoch. The port's kernels appear in it by their CUDA
    symbols (`stf::lstm_last_x_tc_kernel`, ...), launched through ctypes.
  * `annotate(name)`: a named range in that trace
    (torch.profiler.record_function); train/loop.py and cli/train mark the
    step, the wait for the next batch, the loss read, the evaluation and
    the checkpoint saves.
  * `NanCheck(model)`: the counterpart of jax_debug_nans for
    cli/train --nan-check.
  * `JsonlLogger`: cli/train writes one record per epoch to
    `<model>_metrics_<stamp><tag>.jsonl` beside the parity results .txt.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Iterator, Optional

import torch
import torch.nn as nn


@contextlib.contextmanager
def trace(log_dir: str, rank: int = 0) -> Iterator[str]:
    """Profile the block (CPU activity, and CUDA activity where a GPU is
    visible) and write its trace to `log_dir/trace_rank<rank>.json` on
    exit. Yields the file's path."""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_rank{rank}.json")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
    print(f"profiler trace: {path}")


def annotate(name: str):
    """Named region visible in profiler timelines."""
    return torch.profiler.record_function(name)


def _has_nan(value) -> bool:
    if isinstance(value, torch.Tensor):
        return value.is_floating_point() and bool(torch.isnan(value).any())
    if isinstance(value, dict):
        return any(_has_nan(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return any(_has_nan(v) for v in value)
    return False


class NanCheck:
    """Installed on `model`: forward hooks on every leaf module of it
    (the pixel-LSTM modules among them, so the outputs of the K1 / K3
    kernels are checked) raise FloatingPointError at the first output
    holding a NaN, naming the module; a pre-hook on the model
    checks its input, the augmentation's (kernel K2's) output. Within
    `backward_checked()` autograd runs in anomaly mode with check_nan:
    the first backward function that returns a NaN (LstmLastX's, which
    runs K1b, among them) raises FloatingPointError naming it. Only NaN
    raises, as with jax_debug_nans: an inf passes. Each check reads a
    flag back from the device, so a checked step runs much slower."""

    def __init__(self, model: nn.Module):
        self.handles = [model.register_forward_pre_hook(self._check_input)]
        for name, module in model.named_modules():
            if name and not any(True for _ in module.children()):
                self.handles.append(module.register_forward_hook(
                    self._output_check(name, module)))

    @staticmethod
    def _check_input(module, args):
        if _has_nan(args):
            raise FloatingPointError(
                "NaN in the model's input (the augmented batch)")

    @staticmethod
    def _output_check(name: str, module: nn.Module):
        kind = type(module).__name__

        def hook(mod, args, out):
            if _has_nan(out):
                raise FloatingPointError(
                    f"NaN in the output of module {name!r} ({kind})")
        return hook

    @staticmethod
    def check_loss(loss: torch.Tensor) -> None:
        if _has_nan(loss):
            raise FloatingPointError("NaN in the training loss")

    @contextlib.contextmanager
    def backward_checked(self) -> Iterator[None]:
        try:
            with torch.autograd.detect_anomaly(check_nan=True):
                yield
        except RuntimeError as e:
            if "nan values" not in str(e):
                raise
            raise FloatingPointError(f"NaN in the backward: {e}") from e

    def remove(self) -> None:
        for h in self.handles:
            h.remove()
        self.handles = []


class JsonlLogger:
    """Append-only structured metrics: one JSON object per line with a
    wall-clock timestamp and step/epoch tags."""

    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)

    def log(self, record: Dict[str, Any]) -> None:
        if not self.path:
            return
        record = {"ts": time.time(), **record}
        with open(self.path, "a") as f:
            f.write(json.dumps(record, default=float) + "\n")
