"""The port's spans (utils/profiling.annotate, record_spans) and where
train/loop.train_one_epoch opens them, on the CPU.

  * with neither a recorder nor a profiler, annotate enters nothing and
    records nothing;
  * under record_spans, a 3-step epoch of the tiny UNet gives each of
    the seven spans once per step, with its step id and parent, the four
    phases inside the step, the first batch wait opening before the
    epoch's iterator is made and every loss read one step late;
  * under the CPU profiler each span, placed by its time.time_ns()
    stamps at their offset from trace_start_ns(), lies within its own
    profiler range (to 5 us) and opens a median of under 100 us after
    it: the spans and the trace share one clock. (Each start within
    100 us would fail on a scheduler's preemption between the two
    stamps.);
  * a batch copied ahead hands its tensors over to the step that uses
    them.
"""

import statistics
import threading
import time

import pytest
import torch

from stf_unet_tpu_torch.core.config import DataConfig, ModelConfig, OptimConfig
from stf_unet_tpu_torch.data.index import DatasetIndex
from stf_unet_tpu_torch.data.loader import HostLoader
from stf_unet_tpu_torch.data.synthetic import make_synthetic_breadm
from stf_unet_tpu_torch.data.transforms import TrainAugment
from stf_unet_tpu_torch.models.registry import create_model
from stf_unet_tpu_torch.train.loop import DeviceBatch, train_one_epoch
from stf_unet_tpu_torch.train.schedule import warmup_poly_schedule
from stf_unet_tpu_torch.train.state import TrainState, make_optimizer
from stf_unet_tpu_torch.utils import profiling

SEQ = ("VIBRANT+C1", "VIBRANT+C2")
PHASES = ("augment", "forward", "backward", "optimizer")
TOP = ("data_wait", "train_step", "loss_read")
STEPS = 3
CLOCK_US = 100
SLACK_US = 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file's small CPU steps: the test
    workers share the host's cores, and torch's default of a thread per
    core makes each tiny op of one worker wait on the others'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class BuildStamp:
    """The loader handed to train_one_epoch, stamping when an epoch's
    iterator is made."""

    def __init__(self, loader):
        self.loader, self.built_ns = loader, []

    def __len__(self):
        return len(self.loader)

    def epoch(self, epoch_num=0, skip_batches=0):
        self.built_ns.append(time.time_ns())
        return self.loader.epoch(epoch_num, skip_batches=skip_batches)


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    """A tiny UNet's state, the loader (3 batches of 2) and the
    augmentation."""
    root = make_synthetic_breadm(str(tmp_path_factory.mktemp("data")),
                                 size=40, time_steps=2, patients_per_split=2,
                                 slices_per_patient=3, seed=4)
    index = DatasetIndex(root, "train", SEQ)
    loader = HostLoader(index, 2, shuffle=True, seed=5, verbose=False)
    assert len(loader) == STEPS
    torch.manual_seed(0)
    model = create_model(ModelConfig(model="unet", time_steps=2, base_c=4))
    cpu = torch.device("cpu")
    state = TrainState(model, make_optimizer(OptimConfig(), model, cpu))
    augment = TrainAugment(DataConfig(base_size=40, crop_size=32,
                                      sequence_types=SEQ))
    schedule = warmup_poly_schedule(1e-3, STEPS, 10, warmup=False)
    return state, loader, augment, schedule


def _epoch(trainer, loader, device_prefetch=1, epoch=0):
    state, _, augment, schedule = trainer
    return train_one_epoch(state, loader, augment, 7, epoch, schedule, 2,
                           torch.device("cpu"), print_freq=100,
                           device_prefetch=device_prefetch)


def test_annotate_off_enters_nothing_and_records_nothing(monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    with profiling.record_spans() as rec:
        with profiling.annotate("inside"):
            pass
    kept = list(rec.spans)
    first, second = profiling.annotate("a"), profiling.annotate("b", (0, 1))
    with first, second:
        pass
    assert first is second  # one shared empty context
    assert entered == []
    assert [s.name for s in rec.spans] == ["inside"] and rec.spans == kept


def _span_elsewhere():
    with profiling.annotate("other"):
        pass


def test_record_spans_refuses_to_nest_and_keeps_threads_apart():
    with profiling.record_spans() as rec:
        with pytest.raises(RuntimeError):
            with profiling.record_spans():
                pass
        with profiling.annotate("outer", (2, 5)):
            worker = threading.Thread(target=_span_elsewhere)
            worker.start()
            worker.join(timeout=10)
            with profiling.annotate("inner"):
                pass
    assert not worker.is_alive()
    spans = {s.name: s for s in rec.spans}
    assert spans["inner"].parent is spans["outer"]
    assert spans["inner"].step == (2, 5)
    # a span opened on another thread has no parent there
    assert spans["other"].parent is None and spans["other"].step is None
    assert spans["other"].thread != spans["outer"].thread
    # the recorder is gone with its block
    assert profiling.annotate("after") is profiling.annotate("again")


@pytest.mark.parametrize("device_prefetch", [0, 1])
def test_an_epoch_spans_each_step_once(trainer, device_prefetch):
    loader = BuildStamp(trainer[1])
    with profiling.record_spans() as rec:
        _, _, reached = _epoch(trainer, loader, device_prefetch)
    assert reached == STEPS
    by = {}
    for s in rec.spans:
        assert s.end_ns is not None and s.end_ns >= s.start_ns, s.name
        by.setdefault((s.name, s.step), []).append(s)
    steps = [(0, i) for i in range(STEPS)]
    assert set(by) == {(n, st) for n in TOP + PHASES for st in steps}
    assert all(len(v) == 1 for v in by.values()), sorted(by)
    trainer_thread = threading.get_ident()
    for st in steps:
        step = by[("train_step", st)][0]
        for name in TOP:
            span = by[(name, st)][0]
            assert span.parent is None and span.thread == trainer_thread
        for name in PHASES:
            span = by[(name, st)][0]
            assert span.parent is step
            assert step.start_ns <= span.start_ns <= span.end_ns \
                <= step.end_ns
        wait = by[("data_wait", st)][0]
        assert wait.end_ns <= step.start_ns
        # the loss is read one step late; the last read ends the epoch
        read = by[("loss_read", st)][0]
        after = by.get(("train_step", (0, st[1] + 1)))
        assert read.start_ns >= (after[0] if after else step).end_ns
    starts = [by[(n, steps[0])][0].start_ns for n in PHASES]
    assert starts == sorted(starts)
    first_wait = by[("data_wait", (0, 0))][0]
    assert first_wait.start_ns <= loader.built_ns[0] <= first_wait.end_ns


class FakeStream:
    def __init__(self):
        self.waited = []

    def wait_event(self, event):
        self.waited.append(event)


class FakeTensor:
    device = "cuda:0"

    def __init__(self):
        self.streams = []

    def record_stream(self, stream):
        self.streams.append(stream)


def test_a_prefetched_batch_hands_its_tensors_over(monkeypatch):
    """A batch copied ahead on a side stream (`ready` set) is used once:
    tensors() makes the current stream wait for its copy, records the
    stream's use and lets go of the tensors, so that they are freed in
    the step's augment span and not between the batch wait and the step.
    A batch made in place keeps its tensors for every call."""
    stream = FakeStream()
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: stream)
    frames, masks, ready = FakeTensor(), FakeTensor(), object()
    batch = DeviceBatch(frames, masks, None, None, ready=ready)
    assert batch.tensors() == (frames, masks, None)
    assert stream.waited == [ready]
    assert frames.streams == masks.streams == [stream]
    assert (batch.frames, batch.masks, batch.ready) == (None, None, None)
    kept = DeviceBatch(torch.zeros(1), torch.ones(1), None, None)
    for _ in range(2):
        got = kept.tensors()
        assert got[0] is kept.frames and got[1] is kept.masks


def test_spans_share_the_profilers_clock(trainer):
    from torch.profiler import ProfilerActivity, profile

    # the process's first ranges pay the profiler's op lookups, which
    # fall between a span's stamp and its range's
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.record_spans():
            _epoch(trainer, trainer[1], epoch=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.record_spans() as rec:
            _epoch(trainer, trainer[1], epoch=2)
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    names = TOP + PHASES
    events = sorted((e for e in prof.events() if e.name in names),
                    key=lambda e: e.time_range.start)
    assert len(events) == len(rec.spans) == STEPS * len(names)
    offsets = []
    for name in names:
        mine = [s for s in rec.spans if s.name == name]
        theirs = [e for e in events if e.name == name]
        assert len(mine) == len(theirs) == STEPS
        for span, event in zip(mine, theirs):
            # the span is stamped inside its range: on one clock the
            # range holds it, to the conversion's microseconds
            begin_us = (span.start_ns - start_ns) / 1e3
            end_us = (span.end_ns - start_ns) / 1e3
            assert event.time_range.start - SLACK_US <= begin_us, name
            assert end_us <= event.time_range.end + SLACK_US, name
            offsets.append(begin_us - event.time_range.start)
    assert statistics.median(offsets) <= CLOCK_US
