"""Profiling, the NaN check and structured metrics (counterpart of
stf_unet_tpu/utils/profiling.py).

  * `trace(log_dir)`: a torch.profiler session over CPU and CUDA activity
    that writes a Chrome / Perfetto trace, `log_dir/trace_rank<r>.json`
    (one file per rank under data parallelism); cli/train --profile-dir
    traces the first epoch. The port's kernels appear in it by their CUDA
    symbols (`stf::lstm_last_x_tc_kernel`, ...), launched through ctypes.
  * `annotate(name, step=None)`: a named span of host time. Under a
    profiler it is a range in the trace (torch.profiler.record_function);
    inside `record_spans()` it is also kept in memory as a `Span`, on the
    Unix clock that the profiler stamps its events on. With neither it
    costs a flag read and enters nothing. train/loop.py marks each
    training step and, inside it, the augmentation, the forward, the
    backward and the optimizer, besides the wait for the next batch and
    the loss read; loop.evaluate and cli/train mark the evaluation and
    the checkpoint saves.
  * `record_spans()`: keeps every span the block's annotations open, on
    every thread, for a caller that reads them when the block ends
    (nothing is written to disk).
  * `NanCheck(model)`: the counterpart of jax_debug_nans for
    cli/train --nan-check.
  * `JsonlLogger`: cli/train writes one record per epoch to
    `<model>_metrics_<stamp><tag>.jsonl` beside the parity results .txt.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

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


_NOTHING = contextlib.nullcontext()


class Span:
    """One span of host time: `start_ns` and `end_ns` by time.time_ns(),
    the Unix clock on which torch.profiler places its events (at the
    trace's `trace_start_ns()` plus each event's offset). `step` is the
    training step's (epoch, step in the epoch), taken from the enclosing
    span where not given; `parent` the span that was open on the same
    thread when this one opened."""

    __slots__ = ("name", "parent", "step", "thread", "start_ns", "end_ns")

    def __init__(self, name: str, parent: Optional["Span"],
                 step: Optional[Tuple[int, int]]):
        self.name, self.parent = name, parent
        self.step = step if step is not None or parent is None \
            else parent.step
        self.thread = threading.get_ident()
        self.start_ns = time.time_ns()
        self.end_ns: Optional[int] = None


class SpanRecorder:
    """The spans of a `record_spans()` block, in the order they opened."""

    def __init__(self):
        self.spans: List[Span] = []
        self._local = threading.local()  # each thread's open spans

    @contextlib.contextmanager
    def span(self, name: str, step: Optional[Tuple[int, int]]):
        """The span, inside the profiler's range of it where one runs."""
        traced = torch._C._autograd._profiler_enabled()
        with torch.profiler.record_function(name) if traced else _NOTHING:
            stack = getattr(self._local, "open", None)
            if stack is None:
                stack = self._local.open = []
            span = Span(name, stack[-1] if stack else None, step)
            self.spans.append(span)
            stack.append(span)
            try:
                yield span
            finally:
                span.end_ns = time.time_ns()
                stack.pop()


_recorder: Optional[SpanRecorder] = None


@contextlib.contextmanager
def record_spans() -> Iterator[SpanRecorder]:
    """Keep every span that `annotate` opens within the block; yields
    the recorder, whose `spans` the caller reads."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("spans are already being recorded")
    _recorder = SpanRecorder()
    try:
        yield _recorder
    finally:
        _recorder = None


def annotate(name: str, step: Optional[Tuple[int, int]] = None):
    """A named span: kept by `record_spans()`, a range in a running
    profiler's trace, and with neither a shared empty context."""
    recorder = _recorder
    if recorder is not None:
        return recorder.span(name, step)
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NOTHING


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
