"""Stdlib HTTP front end for the serving engine (counterpart of
stf_unet_tpu/serve/http.py; same wire contract).

Endpoints:
  GET  /healthz          -> {"status": "ok", "model": ..., "requests": N}
  GET  /metrics          -> request count, latency p50/p90/p99 ms, batch
                            count and mean size, the input shapes run so
                            far (?format=prometheus for text exposition)
  POST /v1/segment       -> body: npz with "frames" uint8 [T, H, W], any
                            H/W (the server applies the training-parity
                            short-edge resize). Response: JSON mask shape +
                            per-class pixel counts, or ?format=npz for the
                            mask array, or ?format=png for a PNG render.
                            ?full_size=1 nearest-upsamples the mask back to
                            the input H/W. ?probs=1 returns an npz with the
                            mask AND float16 softmax probabilities (direct
                            engine call, skips the dynamic batcher).
  POST /v1/reload        -> 501: weight reload is not ported yet.

ThreadingHTTPServer accepts concurrent clients; every request blocks on
the DynamicBatcher, which owns the device.
"""

from __future__ import annotations

import io
import json
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch.nn as nn

from stf_unet_tpu_torch.core.config import DataConfig
from stf_unet_tpu_torch.data.transforms import eval_preprocess
from stf_unet_tpu_torch.ops.resize import _nearest_indices
from stf_unet_tpu_torch.serve.engine import DynamicBatcher, InferenceEngine


class ServerStats:
    def __init__(self, maxlen: int = 4096):
        self.lock = threading.Lock()
        self.latencies_ms: deque = deque(maxlen=maxlen)
        self.requests = 0
        self.errors = 0

    def record(self, ms: float) -> None:
        with self.lock:
            self.requests += 1
            self.latencies_ms.append(ms)

    def record_error(self) -> None:
        with self.lock:
            self.errors += 1

    def summary(self) -> dict:
        with self.lock:
            lat = sorted(self.latencies_ms)
            n = len(lat)
            q = (lambda p: lat[min(n - 1, int(p * n))]) if n else (lambda p: 0.0)
            return {
                "requests": self.requests,
                "errors": self.errors,
                "latency_ms": {"p50": round(q(0.50), 3),
                               "p90": round(q(0.90), 3),
                               "p99": round(q(0.99), 3)},
            }


def _upsample_nearest(arr: np.ndarray, h: int, w: int) -> np.ndarray:
    rows = _nearest_indices(arr.shape[0], h)
    cols = _nearest_indices(arr.shape[1], w)
    return arr[rows][:, cols]


class SegmentationServer:
    """Owns engine + batcher + HTTP server. start()/stop() lifecycle."""

    # Both models downsample 32x at the bottleneck; serving accepts any
    # aspect ratio by padding the resized input up to the stride with raw
    # black and cropping the mask back.
    STRIDE = 32

    def __init__(self, model: nn.Module, data_cfg: DataConfig, *,
                 model_name: str = "", host: str = "127.0.0.1",
                 port: int = 0, max_batch: int = 8, window_ms: float = 5.0,
                 device="cuda", infer_timeout_s: float = 300.0):
        self.data_cfg = data_cfg
        self.model_name = model_name
        self.infer_timeout_s = float(infer_timeout_s)
        self.engine = InferenceEngine(model, data_cfg.mean, data_cfg.std,
                                      max_batch=max_batch, device=device)
        self.batcher = DynamicBatcher(self.engine, max_batch=max_batch,
                                      window_ms=window_ms)
        self.stats = ServerStats()
        self.httpd = ThreadingHTTPServer((host, port), _make_handler(self))
        self.httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        return self.httpd.server_address[:2]

    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.batcher.close()

    def preprocess(self, frames: np.ndarray
                   ) -> Tuple[np.ndarray, Tuple[int, int]]:
        """uint8 [T, H, W] -> ([T, h'', w'', 1] stride-padded short-edge-
        resized uint8, (h', w') the unpadded resized size)."""
        dummy_mask = np.zeros(frames.shape[1:], np.uint8)
        image, _ = eval_preprocess(frames, dummy_mask, self.data_cfg,
                                   raw=True)
        _, h, w, _ = image.shape
        ph, pw = -h % self.STRIDE, -w % self.STRIDE
        if ph or pw:
            image = np.pad(image, ((0, 0), (0, ph), (0, pw), (0, 0)))
        return image, (h, w)

    def segment(self, frames: np.ndarray, full_size: bool = False
                ) -> np.ndarray:
        image, (h, w) = self.preprocess(frames)
        mask = self.batcher.infer(image, timeout=self.infer_timeout_s)[:h, :w]
        if full_size and mask.shape != frames.shape[1:]:
            mask = _upsample_nearest(mask, *frames.shape[1:])
        return mask

    def segment_probs(self, frames: np.ndarray, full_size: bool = False):
        """(mask, float16 softmax probs [h, w, C]) for ?probs=1 requests;
        calls the engine directly (probs requests are rare analysis
        traffic and skip the batcher)."""
        image, (h, w) = self.preprocess(frames)
        masks, probs = self.engine.predict(image[None], return_probs=True)
        mask, prob = masks[0][:h, :w], probs[0][:h, :w]
        if full_size and mask.shape != frames.shape[1:]:
            mask = _upsample_nearest(mask, *frames.shape[1:])
            prob = _upsample_nearest(prob, *frames.shape[1:])
        return mask, prob


def _make_handler(server: SegmentationServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet; /metrics has the data
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj: dict) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json")

        def _send_npz(self, **arrays) -> None:
            buf = io.BytesIO()
            np.savez_compressed(buf, **arrays)
            self._send(200, buf.getvalue(), "application/octet-stream")

        def do_GET(self):
            if self.path == "/healthz":
                self._send_json(200, {"status": "ok",
                                      "model": server.model_name,
                                      "requests": server.stats.requests})
            elif self.path.startswith("/metrics"):
                out = server.stats.summary()
                sizes = list(server.batcher.batch_sizes)  # bounded window
                out["batches"] = server.batcher.total_batches
                out["mean_batch"] = (round(sum(sizes) / len(sizes), 2)
                                     if sizes else 0.0)
                out["seen_shapes"] = sorted(
                    list(s) for s in server.engine.seen_shapes)
                if "format=prometheus" in (self.path.split("?", 1) + [""])[1]:
                    lines = [
                        "# TYPE stf_requests_total counter",
                        f"stf_requests_total {out['requests']}",
                        "# TYPE stf_errors_total counter",
                        f"stf_errors_total {out['errors']}",
                        "# TYPE stf_latency_ms summary",
                    ]
                    for q, v in out["latency_ms"].items():
                        lines.append("stf_latency_ms{quantile=\"0."
                                     + q[1:] + "\"} " + str(v))
                    lines += [
                        "# TYPE stf_batches_total counter",
                        f"stf_batches_total {out['batches']}",
                        "# TYPE stf_mean_batch_size gauge",
                        f"stf_mean_batch_size {out['mean_batch']}",
                    ]
                    self._send(200, ("\n".join(lines) + "\n").encode(),
                               "text/plain; version=0.0.4")
                else:
                    self._send_json(200, out)
            else:
                self._send_json(404, {"error": "not found"})

        def do_POST(self):
            url = urlparse(self.path)
            # ALWAYS drain the body: HTTP/1.1 keep-alive connections
            # desynchronize if unread bytes are left on rfile.
            length = int(self.headers.get("Content-Length", "0"))
            payload = self.rfile.read(length) if length else b""
            if url.path == "/v1/reload":
                self._send_json(501, {"error": "weight reload is not ported "
                                               "yet; restart the server"})
                return
            if url.path != "/v1/segment":
                self._send_json(404, {"error": "not found"})
                return
            qs = parse_qs(url.query)
            fmt = qs.get("format", ["json"])[0]
            full = qs.get("full_size", ["0"])[0] in ("1", "true")
            want_probs = qs.get("probs", ["0"])[0] in ("1", "true")
            if want_probs and fmt == "png":
                self._send_json(400, {"error": "probs=1 returns an npz "
                                               "(mask + probs); png cannot "
                                               "carry probabilities"})
                return
            try:
                with np.load(io.BytesIO(payload)) as npz:
                    frames = np.asarray(npz["frames"])
                if frames.ndim != 3 or frames.dtype != np.uint8:
                    raise ValueError(
                        f"frames must be uint8 [T, H, W]; got "
                        f"{frames.dtype} {frames.shape}")
            except Exception as e:  # the CLIENT's payload is malformed
                server.stats.record_error()
                self._send_json(400, {"error": str(e)})
                return
            try:
                t0 = time.perf_counter()
                if want_probs:
                    mask, probs = server.segment_probs(frames,
                                                       full_size=full)
                else:
                    mask = server.segment(frames, full_size=full)
                server.stats.record((time.perf_counter() - t0) * 1000.0)
            except TimeoutError as e:  # transient: retryable, not a 4xx
                server.stats.record_error()
                self._send_json(503, {"error": str(e)})
                return
            except ValueError as e:
                server.stats.record_error()
                self._send_json(400, {"error": str(e)})
                return
            except Exception as e:  # server-side failure (device/kernel)
                server.stats.record_error()
                self._send_json(500, {"error": str(e)})
                return
            # masks with class indices past a byte must not wrap
            fits_u8 = int(mask.max(initial=0)) <= 255
            mask_out = mask.astype(np.uint8) if fits_u8 else mask
            if want_probs:  # npz regardless of format=json default
                self._send_npz(mask=mask_out, probs=probs)
            elif fmt == "npz":
                self._send_npz(mask=mask_out)
            elif fmt == "png":
                if not fits_u8:
                    self._send_json(400, {
                        "error": "png format supports <=256 classes; "
                                 "use ?format=npz"})
                    return
                from PIL import Image

                buf = io.BytesIO()
                arr = mask.astype(np.uint8)
                if int(arr.max(initial=0)) <= 1:  # binary: render 0/255
                    arr = arr * 255
                Image.fromarray(arr).save(buf, format="PNG")
                self._send(200, buf.getvalue(), "image/png")
            else:
                vals, counts = np.unique(mask, return_counts=True)
                self._send_json(200, {
                    "mask_shape": list(mask.shape),
                    "class_pixels": {int(v): int(c)
                                     for v, c in zip(vals, counts)},
                })

    return Handler
