"""Serving inference engine with shape-bucketed dynamic batching
(counterpart of stf_unet_tpu/serve/engine.py).

  * Requests ship PIL-parity-resized uint8 frames; normalization runs on
    the device, inside the same forward as the model.
  * Batches are padded up to power-of-two sizes (1, 2, 4, ... max_batch)
    by replicating row 0, and the padding is sliced off. The JAX package
    pads to bound its compile count; here it keeps the kernels' row counts
    on the few shapes that warmup ran and PERF.md measured.
  * The forward runs eagerly under torch.inference_mode(); there is no
    compile step. Device work is serialized by one lock per engine.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch
import torch.nn as nn

from stf_unet_tpu_torch.core.config import resolve_device
from stf_unet_tpu_torch.data.transforms import normalize
from stf_unet_tpu_torch.models.registry import preprocess_input


class InferenceEngine:
    """Argmax-segmentation forward over raw uint8 inputs.

    predict() takes [B, T, h, w, 1] uint8 and returns int32 masks [B, h, w].
    `model` is an eval-mode module on `device`.
    """

    def __init__(self, model: nn.Module, mean: float, std: float,
                 max_batch: int = 8, device="cuda"):
        self.model = model
        self.mean = float(mean)
        self.std = float(std)
        self.max_batch = int(max_batch)
        self.device = resolve_device(device)
        # masks leave the device as uint8 when classes fit a byte
        self._mask_dtype = (torch.uint8 if int(model.num_classes) <= 256
                            else torch.int32)
        self.seen_shapes: Set[Tuple[int, ...]] = set()
        self._lock = threading.Lock()

    def _bucket(self, n: int) -> int:
        b = 1
        while b < n and b < self.max_batch:
            b *= 2
        # a non-power-of-two --max-batch is a memory cap: never pad past it
        return min(b, self.max_batch)

    def predict(self, images: np.ndarray, return_probs: bool = False):
        """images uint8 [B, T, h, w, 1] -> masks int32 [B, h, w];
        return_probs=True also returns float16 softmax probabilities
        [B, h, w, C] from the same forward."""
        n = images.shape[0]
        b = self._bucket(n)
        if n < b:  # pad by replicating row 0; sliced off below
            images = np.concatenate(
                [images, np.repeat(images[:1], b - n, axis=0)], axis=0)
        with self._lock, torch.inference_mode():
            self.seen_shapes.add(tuple(images.shape))
            x = torch.from_numpy(np.ascontiguousarray(images)).to(
                self.device)
            x = normalize(x, self.mean, self.std)
            logits = self.model(preprocess_input(x, self.model))["out"]
            masks = torch.argmax(logits, dim=-1).to(self._mask_dtype)
            masks = masks.cpu().numpy().astype(np.int32)[:n]
            if not return_probs:
                return masks
            probs = torch.softmax(logits, dim=-1).to(torch.float16)
            return masks, probs.cpu().numpy()[:n]

    def warmup(self, t_steps: int, h: int, w: int) -> None:
        """Build the kernels and run every batch bucket of one input
        geometry once, plus the batch-1 probs request."""
        for b in sorted({self._bucket(i + 1)
                         for i in range(self.max_batch)}):
            self.predict(np.zeros((b, t_steps, h, w, 1), np.uint8))
        self.predict(np.zeros((1, t_steps, h, w, 1), np.uint8),
                     return_probs=True)


class _Request:
    __slots__ = ("image", "event", "mask", "error", "enqueue_t")

    def __init__(self, image: np.ndarray):
        self.image = image
        self.event = threading.Event()
        self.mask: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.enqueue_t = time.perf_counter()


class DynamicBatcher:
    """Coalesce concurrent same-shape requests into one device batch.

    Requests queue per input shape; a single worker thread takes the
    oldest request's shape, waits up to `window_ms` for peers (or until
    `max_batch` accumulate), runs the engine once, and fans results back
    out. One worker owns the device, so dispatch stays serialized.
    """

    def __init__(self, engine: InferenceEngine, max_batch: int = 8,
                 window_ms: float = 5.0):
        self.engine = engine
        self.max_batch = int(max_batch)
        self.window_s = float(window_ms) / 1000.0
        self._lock = threading.Condition()
        self._queues: Dict[Tuple[int, ...], deque] = {}
        self._order: deque = deque()  # shapes in arrival order
        self._stop = False
        # observed batch sizes: a bounded window + a lifetime counter
        self.batch_sizes: deque = deque(maxlen=4096)
        self.total_batches = 0
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, image: np.ndarray) -> _Request:
        req = _Request(image)
        shape = tuple(image.shape)
        with self._lock:
            self._queues.setdefault(shape, deque()).append(req)
            self._order.append(shape)
            self._lock.notify_all()
        return req

    def infer(self, image: np.ndarray, timeout: float = 60.0) -> np.ndarray:
        """Blocking single-sample inference: image [T, h, w, 1] uint8 ->
        mask [h, w] int32."""
        req = self.submit(image)
        if not req.event.wait(timeout):
            raise TimeoutError("inference timed out")
        if req.error is not None:
            raise req.error
        return req.mask

    def close(self) -> None:
        with self._lock:
            self._stop = True
            self._lock.notify_all()
        self._worker.join(timeout=5)

    def _collect(self) -> Optional[List[_Request]]:
        """Wait for work; return one same-shape batch."""
        with self._lock:
            while not self._order and not self._stop:
                self._lock.wait()
            if self._stop and not self._order:
                return None
            shape = self._order[0]
            q = self._queues[shape]
            deadline = q[0].enqueue_t + self.window_s
            while len(q) < self.max_batch and not self._stop:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                self._lock.wait(remaining)
            batch = []
            while q and len(batch) < self.max_batch:
                batch.append(q.popleft())
                self._order.remove(shape)
            if not q:
                del self._queues[shape]
            return batch

    def _run(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                return
            images = np.stack([r.image for r in batch], axis=0)
            self.batch_sizes.append(len(batch))
            self.total_batches += 1
            try:
                masks = self.engine.predict(images)
                for r, m in zip(batch, masks):
                    r.mask = m
            except Exception as e:  # surface to every waiter
                for r in batch:
                    r.error = e
            finally:
                for r in batch:
                    r.event.set()
