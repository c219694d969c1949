"""Host-side progress meters (counterpart of stf_unet_tpu/metrics/
meters.py; ref:train_utils/train_and_eval.py:145-296).

The metric values are computed on the device; these meters only smooth and
format them for the console.
"""

from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Iterable, Optional

import torch


class SmoothedValue:
    """Windowed median/avg + global average (ref:145-206)."""

    def __init__(self, window_size: int = 20, fmt: Optional[str] = None):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt or "{median:.4f} ({global_avg:.4f})"

    def update(self, value: float, n: int = 1) -> None:
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        if not d:
            return 0.0
        m = len(d) // 2
        return d[m] if len(d) % 2 else 0.5 * (d[m - 1] + d[m])

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / self.count if self.count > 0 else 0.0

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


def device_peak_memory_mb() -> Optional[float]:
    """Peak CUDA memory allocated by this process in MB, or None without a
    GPU (the reference prints it as 'max mem')."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    return torch.cuda.max_memory_allocated() / (1024.0 * 1024.0)


class MetricLogger:
    """Console logger with iter/data timing and ETA (ref:209-296)."""

    def __init__(self, delimiter: str = "\t"):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def add_meter(self, name: str, meter: SmoothedValue):
        self.meters[name] = meter

    def __str__(self) -> str:
        return self.delimiter.join(f"{n}: {m}" for n, m in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int, header: str = "",
                  total: Optional[int] = None):
        if total is None:
            try:
                total = len(iterable)  # type: ignore[arg-type]
            except TypeError:
                total = 0
        start_time = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        space_fmt = f":{len(str(total))}d"
        i = 0
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or i == total - 1:
                eta = iter_time.global_avg * max(total - i, 0)
                eta_string = str(datetime.timedelta(seconds=int(eta)))
                parts = [
                    header, ("[{0" + space_fmt + "}/{1}]").format(i, total),
                    f"eta: {eta_string}", str(self),
                    f"time: {iter_time}", f"data: {data_time}",
                ]
                mem = device_peak_memory_mb()
                if mem is not None:  # ref prints 'max mem' when on-device
                    parts.append(f"max mem: {mem:.0f}")
                print(self.delimiter.join(parts))
            i += 1
            end = time.time()
        total_time = time.time() - start_time
        total_time_str = str(datetime.timedelta(seconds=int(total_time)))
        per_it = total_time / max(i, 1)
        print(f"{header} Total time: {total_time_str} ({per_it:.4f} s / it)")
