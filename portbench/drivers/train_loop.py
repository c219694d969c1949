"""Traffic kind `train_loop`: the port's trainer over a packed dataset,
as `cli/train --amp true --data-pack` runs it.

Set-up builds one training state (the configuration's model with the
run seed's weights, fused AdamW, the warmup-poly schedule over the
epochs), a HostLoader over the pack (shuffle and augmentation from the
run seed) and the augmentation (K2), then drives the state through its
first `checked_steps` steps with train/loop.train_one_epoch, one step a
call: the warm-up, and the first stretch the check repeats. The window
hands the same state to train_one_epoch, resuming epoch 0 at that step,
epoch after epoch, until the window's seconds are up;
`train_slices_per_s` is every slice stepped over the window's seconds.
The window's own steps are checked too, as two more stretches of
`checked_window_steps` steps: its first, and the first of the next
epoch (after the re-shuffle and the loader's restart); for each, the
state it starts from (parameters, AdamW's moments), AdamW's first
moment after its first step, each step's loss and the parameters after
its last are kept (device copies between the window's steps). A
traced run then steps `profile_warmup_steps` and `profile_steps` more
under torch.profiler (harness/trace). Once
the window has closed, the peak memory read and the state freed, the
reference (portbench/reference/train.py) repeats the stretches from the
same inputs: the first from the seed's weights, the window's from the
state the program held when each began."""

from __future__ import annotations

import gc
import statistics
import sys
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from portbench.harness import common, trace
from portbench.harness.dataset import ensure_pack
from portbench.harness.run import Outcome, Run
from portbench.harness.weights import load_into, seeded_weights, trainable


class TimedLoader:
    """The HostLoader handed to train_one_epoch, each wait for its next
    batch a `loader_next` span (on the device-prefetch thread that
    consumes it)."""

    def __init__(self, loader, spans: common.Spans):
        self.loader = loader
        self.spans = spans

    def __len__(self):
        return len(self.loader)

    def epoch(self, epoch_num: int = 0, skip_batches: int = 0):
        it = self.loader.epoch(epoch_num, skip_batches=skip_batches)
        try:
            while True:
                t0 = time.perf_counter()
                with torch.profiler.record_function("portbench.loader_next"):
                    try:
                        batch = next(it)
                    except StopIteration:
                        return
                self.spans.add("loader_next", t0, time.perf_counter())
                yield batch
        finally:
            it.close()


class Stepper:
    """train_one_epoch over the loader from (epoch, step), each
    train_step call a `train_step` span."""

    def __init__(self, run: Run, state, loader, augment, schedule,
                 spans: common.Spans):
        from stf_unet_tpu_torch.train import loop

        self.loop = loop
        self.run, self.state, self.loader = run, state, loader
        self.augment, self.schedule, self.spans = augment, schedule, spans
        self.epoch, self.step = 0, 0
        self.probes: List[Probe] = []
        self.on_step: Optional[Callable[[], None]] = None

    def positions(self, n: int) -> List[Tuple[int, int]]:
        """(epoch, step in the epoch) of the next n steps."""
        per = len(self.loader)
        at = self.epoch * per + self.step
        return [divmod(at + i, per) for i in range(n)]

    def steps(self, should_stop) -> int:
        """One train_one_epoch call from the current position; returns the
        steps it took."""
        loop = self.loop
        inner = loop.train_step
        at = [self.epoch, self.step]

        def timed(*args, **kwargs):
            for probe in self.probes:
                probe.before_step(tuple(at))
            t0 = time.perf_counter()
            with torch.profiler.record_function("portbench.train_step"):
                out = inner(*args, **kwargs)
            self.spans.add("train_step", t0, time.perf_counter())
            at[1] += 1
            for probe in self.probes:
                probe.after_step(out[0])
            if self.on_step is not None:
                self.on_step()
            return out

        loop.train_step = timed
        try:
            _, _, reached = loop.train_one_epoch(
                self.state, self.loader, self.augment, self.run.seed,
                self.epoch, self.schedule,
                self.run.config["architecture"]["num_classes"],
                self.run.device,
                print_freq=self.run.traffic["print_freq"],
                device_prefetch=self.run.traffic["device_prefetch"],
                start_step=self.step, should_stop=should_stop)
        finally:
            loop.train_step = inner
        taken = reached - self.step
        self.step = reached
        if self.step >= len(self.loader):
            self.epoch, self.step = self.epoch + 1, 0
        return taken

    def run_for(self, n: int) -> None:
        while n > 0:
            count = [0]

            def enough():
                count[0] += 1
                return count[0] >= n

            n -= self.steps(enough)


@dataclass
class Stretch:
    """Steps the reference repeats: where they fall, the state they start
    from (the trainable leaves; AdamW's moments and step count, None and 0
    for a fresh optimizer) and what the program made of them."""
    positions: List[Tuple[int, int]]
    start: Dict[str, torch.Tensor]
    moments: Optional[tuple]
    t0: int
    losses: List[float]
    grads: Dict[str, torch.Tensor]    # the first step's, from AdamW's m
    deltas: Dict[str, torch.Tensor]   # the parameters' change over them


def _moment(state, named: dict, key: str) -> Dict[str, torch.Tensor]:
    opt = state.optimizer.state
    return {k: (opt[p][key].detach().clone() if key in opt[p]
                else torch.zeros_like(p, dtype=torch.float32))
            for k, p in named.items()}


class Probe:
    """n steps of the window from (epoch, step): the state before the
    first (parameters, AdamW's moments and step count), AdamW's first
    moment after it, each step's loss (on the device) and the parameters
    after the n-th, all device copies."""

    def __init__(self, stepper: "Stepper", opens_at: Tuple[int, int],
                 n: int):
        self.state, self.n = stepper.state, n
        self.named = dict(self.state.model.named_parameters())
        self.beta1 = self.state.optimizer.param_groups[0]["betas"][0]
        per = len(stepper.loader)
        first = opens_at[0] * per + opens_at[1]
        self.positions = [divmod(first + i, per) for i in range(n)]
        self.start = self.m1 = self.end = None
        self.losses: list = []

    @property
    def done(self) -> bool:
        return self.end is not None

    def before_step(self, position: Tuple[int, int]) -> None:
        if self.start is None and position == self.positions[0]:
            self.t0 = int(self.state.step)
            with torch.no_grad():
                self.start = {k: p.detach().float().clone()
                              for k, p in self.named.items()}
                self.m0 = _moment(self.state, self.named, "exp_avg")
                self.v0 = _moment(self.state, self.named, "exp_avg_sq")

    def after_step(self, loss: torch.Tensor) -> None:
        if self.start is None or self.done:
            return
        self.losses.append(loss)
        with torch.no_grad():
            if len(self.losses) == 1:
                self.m1 = _moment(self.state, self.named, "exp_avg")
            if len(self.losses) == self.n:
                self.end = {k: p.detach().float().clone()
                            for k, p in self.named.items()}

    def stretch(self) -> Stretch:
        if not self.done:
            raise RuntimeError(f"the probe at {self.positions[0]} took "
                               f"{len(self.losses)} of its {self.n} steps")
        b1 = self.beta1
        grads = {k: (self.m1[k] - b1 * self.m0[k]) / (1.0 - b1)
                 for k in self.named}
        return Stretch(self.positions, self.start, (self.m0, self.v0),
                       self.t0, [float(x) for x in self.losses], grads,
                       {k: self.end[k] - self.start[k] for k in self.named})


def window_probes(stepper: "Stepper", n: int) -> List[Probe]:
    """The window's own checked steps: its first n, and the first n of
    the next epoch (after the re-shuffle and the loader's restart)."""
    return [Probe(stepper, (stepper.epoch, stepper.step), n),
            Probe(stepper, (stepper.epoch + 1, 0), n)]


def _build(run: Run, spans: common.Spans):
    from stf_unet_tpu_torch.cli.common import set_precision_policy
    from stf_unet_tpu_torch.core.config import (DataConfig, ModelConfig,
                                                OptimConfig)
    from stf_unet_tpu_torch.data.index import DatasetIndex
    from stf_unet_tpu_torch.data.loader import HostLoader
    from stf_unet_tpu_torch.data.pack import open_split_pack
    from stf_unet_tpu_torch.data.transforms import TrainAugment
    from stf_unet_tpu_torch.models.registry import create_model
    from stf_unet_tpu_torch.train import state as state_lib
    from stf_unet_tpu_torch.train.schedule import warmup_poly_schedule

    tr, arch = run.traffic, run.config["architecture"]
    data_cfg = DataConfig(**tr["augment"],
                          device_prefetch=tr["device_prefetch"],
                          prefetch=tr["host_prefetch"])
    seq_types = data_cfg.resolved_sequence_types
    tree, pack_root = ensure_pack(run.spec.root, tr["dataset"], seq_types)
    set_precision_policy("default")
    index = DatasetIndex(str(tree), "train", seq_types)
    loader = HostLoader(index, tr["batch_size"], shuffle=True, seed=run.seed,
                        prefetch=tr["host_prefetch"],
                        pack=open_split_pack(str(pack_root), "train"))
    model_cfg = ModelConfig(model=run.config["model"],
                            num_classes=arch["num_classes"] - 1,
                            time_steps=arch["time_steps"],
                            base_c=arch.get("base_c", ModelConfig.base_c))
    with torch.device(run.device):
        model = create_model(model_cfg, dtype=run.compute_dtype)
    weights = seeded_weights(model, run.seed, run.device,
                             run.config["zero_leaves"])
    load_into(model, weights)
    opt = tr["optim"]
    optim_cfg = OptimConfig(lr=opt["lr"], weight_decay=opt["weight_decay"],
                            beta1=opt["beta1"], beta2=opt["beta2"],
                            eps=opt["eps"], warmup_epochs=opt["warmup_epochs"],
                            warmup_factor=opt["warmup_factor"],
                            poly_power=opt["poly_power"])
    state = state_lib.TrainState(
        model, state_lib.make_optimizer(optim_cfg, model, run.device))
    schedule = warmup_poly_schedule(
        opt["lr"], len(loader), opt["epochs"], warmup=True,
        warmup_epochs=opt["warmup_epochs"],
        warmup_factor=opt["warmup_factor"], power=opt["poly_power"])
    stepper = Stepper(run, state, TimedLoader(loader, spans),
                      TrainAugment(data_cfg), schedule, spans)
    return stepper, weights, trainable(model)


def _first_steps(stepper: Stepper, weights: dict, n: int) -> Stretch:
    """The run's first n steps, one train_one_epoch call each."""
    state = stepper.state
    beta1 = state.optimizer.param_groups[0]["betas"][0]
    named = dict(state.model.named_parameters())
    positions = stepper.positions(n)
    losses, grads = [], None
    for _ in range(n):
        loss, _, _ = stepper.loop.train_one_epoch(
            state, stepper.loader, stepper.augment, stepper.run.seed,
            stepper.epoch, stepper.schedule,
            stepper.run.config["architecture"]["num_classes"],
            stepper.run.device, print_freq=stepper.run.traffic["print_freq"],
            device_prefetch=stepper.run.traffic["device_prefetch"],
            start_step=stepper.step, should_stop=lambda: True)
        stepper.step += 1
        if stepper.step >= len(stepper.loader):
            stepper.epoch, stepper.step = stepper.epoch + 1, 0
        losses.append(float(loss))
        if grads is None:  # AdamW's first moment after one step
            grads = {k: m / (1.0 - beta1) for k, m in
                     _moment(state, named, "exp_avg").items()}
    start = {k: weights[k] for k in named}
    with torch.no_grad():
        deltas = {k: p.detach().float() - start[k] for k, p in named.items()}
    return Stretch(positions, start, None, 0, losses, grads, deltas)


def window(stepper: Stepper, probes: List[Probe], stop) -> int:
    """Step from where the stepper stands until stop(), and until every
    probe has its steps: the steps taken."""
    stepper.probes = probes
    steps = 0
    try:
        while not (stop() and all(p.done for p in probes)):
            steps += stepper.steps(
                lambda: stop() and all(p.done for p in probes))
    finally:
        stepper.probes = []
    return steps


def reference(run: Run, weights: dict, names, stretches: List[Stretch],
              q=None, cast=None):
    """The reference's (losses, first gradients, change) over each
    stretch's batches (the shuffle's rows at its positions, regenerated
    from the data seed), from each stretch's start."""
    import importlib

    import numpy as np

    from portbench.harness import synthetic
    from portbench.reference import train as ref

    tr = run.traffic
    ds, bsz = tr["dataset"], tr["batch_size"]
    n = ds["patients"] * ds["slices_per_patient"]
    rows_of = {}
    for s in stretches:
        for epoch, step in s.positions:
            order = ref.shuffle_order(run.seed, epoch, n)
            rows_of[(epoch, step)] = [int(i) for i in
                                      order[step * bsz:(step + 1) * bsz]]
    want = {i: None for rows in rows_of.values() for i in rows}
    for i, (frames, mask) in enumerate(synthetic.slices(
            ds["data_seed"], n, ds["size"], ds["time_steps"])):
        if i in want:
            want[i] = (frames, mask)
    model = importlib.import_module(
        f"portbench.reference.models.{run.config['model']}")
    out = []
    for s in stretches:
        batches = []
        for pos in s.positions:
            rows = [want[i] for i in rows_of[pos]]
            frames = torch.from_numpy(np.stack([r[0] for r in rows])).to(
                run.device)
            masks = torch.from_numpy(np.stack([r[1] for r in rows])).to(
                run.device)
            sizes = torch.full((bsz, 2), ds["size"], dtype=torch.int32)
            batches.append((frames, masks, sizes))
        losses, first, params = ref.train_steps(
            model.forward, run.config["architecture"],
            {**weights, **s.start}, names, batches, s.positions, run.seed,
            tr["augment"], tr["optim"], n // bsz, q=q, cast=cast,
            moments=s.moments, t0=s.t0)
        out.append((losses, first,
                    {k: params[k] - s.start[k].float() for k in names}))
        del batches
    return out


def judge_stretches(stretches: List[Stretch], refs) -> dict:
    """reference/compare's numbers, each the largest over the stretches
    (the first of which is the run's first steps)."""
    from portbench.reference.compare import combine, train_numbers

    scale = refs[0][0][0]
    return combine([train_numbers(s.losses, r[0], s.grads, r[1], s.deltas,
                                  r[2], scale)
                    for s, r in zip(stretches, refs)])


def run(run: Run) -> Outcome:
    from stf_unet_tpu_torch.ops.kernels.lstm_last_x import lstm_last_x
    from stf_unet_tpu_torch.ops.kernels.lstm_last_x_bwd import \
        lstm_last_x_bwd
    from stf_unet_tpu_torch.ops.kernels.warp import warp

    spans = common.Spans()
    print(f"set-up: {common.process_age_s():.2f} s at the driver",
          file=sys.stderr)
    stepper, weights, names = _build(run, spans)
    print(f"set-up: {common.process_age_s():.2f} s with the state built",
          file=sys.stderr)
    tr = run.traffic
    first = _first_steps(stepper, weights, tr["checked_steps"])
    probes = window_probes(stepper, tr["checked_window_steps"])
    spans.seconds.clear()
    dev = run.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = common.process_age_s()
    print(f"set-up {setup_s:.3f} s; window {run.seconds} s", file=sys.stderr)

    t0 = time.perf_counter()
    deadline = t0 + run.seconds
    steps = window(stepper, probes, lambda: time.perf_counter() >= deadline)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t0
    window_spans = spans.snapshot()
    bsz = tr["batch_size"]
    stretches = [first] + [p.stretch() for p in probes]
    del probes

    tail = None
    if run.trace:
        counters = lambda: {"lstm_fwd": lstm_last_x.launches,  # noqa: E731
                            "lstm_bwd": lstm_last_x_bwd.launches,
                            "warp": warp.launches}
        warm, active = tr["profile_warmup_steps"], tr["profile_steps"]
        with trace.Tail(dev, warm, active, counters) as t:
            stepper.on_step = t.step
            stepper.run_for(warm + active)
        stepper.on_step = None
        tail = t.summary(spans)
        tail["steps"] = active

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del stepper
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    numbers = judge_stretches(stretches, reference(run, weights, names,
                                                   stretches))
    print(f"compared: {numbers['detail']}", file=sys.stderr)
    checks = common.judge(numbers, run.limits)
    ctx = {"run": run, "window_s": elapsed, "steps": steps,
           "slices": steps * bsz, "spans": window_spans, "tail": tail,
           "step_host_median_ms": (statistics.median(
               window_spans["train_step"]) * 1e3
               if window_spans.get("train_step") else None)}
    return Outcome(
        correct=common.passed(checks), attempted=steps, failed=0,
        end_to_end={"train_slices_per_s": steps * bsz / elapsed,
                    "setup_s": setup_s},
        checks=checks, memory_peak_bytes=peak, layer_ctx=ctx, tail=tail)
