"""Client SDK for the segmentation server (stdlib-only, mirrors
serve/http.py's wire contract).

    from stf_unet_tpu_torch.serve.client import SegmentationClient
    c = SegmentationClient("http://gpu-host:8421")
    mask = c.segment(frames)             # uint8 [T, H, W] -> int [h, w]
    mask = c.segment(frames, full_size=True)   # back at input H, W
    info = c.segment_summary(frames)     # {"mask_shape", "class_pixels"}
    c.healthz(); c.metrics()

The reference has no serving story at all (its test.py re-imports the
source tree per run, ref:test.py:137-196); this pairs with cli/serve.py
so a deployment's callers don't hand-roll npz-over-HTTP.
"""

from __future__ import annotations

import io
import json
import urllib.error
import urllib.request
from typing import Dict

import numpy as np


class ServerError(RuntimeError):
    """Non-2xx response from the segmentation server (carries the
    server's JSON error message when there is one)."""

    def __init__(self, code: int, message: str):
        super().__init__(f"HTTP {code}: {message}")
        self.code = code


class SegmentationClient:
    def __init__(self, base_url: str, timeout: float = 120.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = float(timeout)

    # -- transport ---------------------------------------------------------

    def _request(self, path: str, data: bytes = None) -> bytes:
        req = urllib.request.Request(
            self.base_url + path, data=data,
            method="POST" if data is not None else "GET")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return r.read()
        except urllib.error.HTTPError as e:
            body = e.read()
            try:
                msg = json.loads(body).get("error", body.decode())
            except Exception:
                msg = body.decode(errors="replace")
            raise ServerError(e.code, msg) from None

    @staticmethod
    def _payload(frames: np.ndarray) -> bytes:
        frames = np.asarray(frames)
        if frames.ndim != 3:
            raise ValueError(f"frames must be [T, H, W]; got {frames.shape}")
        if frames.dtype != np.uint8:
            raise ValueError(f"frames must be uint8; got {frames.dtype}")
        buf = io.BytesIO()
        np.savez(buf, frames=frames)
        return buf.getvalue()

    # -- endpoints ---------------------------------------------------------

    def segment(self, frames: np.ndarray,
                full_size: bool = False) -> np.ndarray:
        """uint8 frames [T, H, W] -> int mask (argmax class indices),
        at the served resolution, or at the input H/W with full_size."""
        q = "?format=npz" + ("&full_size=1" if full_size else "")
        body = self._request("/v1/segment" + q, self._payload(frames))
        with np.load(io.BytesIO(body)) as npz:
            return np.asarray(npz["mask"])

    def segment_probs(self, frames: np.ndarray, full_size: bool = False):
        """(mask, float16 softmax probs [h, w, C]) — uncertainty /
        custom-threshold analysis traffic (?probs=1; skips the server's
        dynamic batcher, unavailable in tiled mode)."""
        q = "?probs=1" + ("&full_size=1" if full_size else "")
        body = self._request("/v1/segment" + q, self._payload(frames))
        with np.load(io.BytesIO(body)) as npz:
            return np.asarray(npz["mask"]), np.asarray(npz["probs"])

    def segment_png(self, frames: np.ndarray,
                    full_size: bool = False) -> bytes:
        """PNG render of the mask (binary masks render 0/255)."""
        q = "?format=png" + ("&full_size=1" if full_size else "")
        return self._request("/v1/segment" + q, self._payload(frames))

    def segment_summary(self, frames: np.ndarray) -> Dict:
        """JSON summary: mask_shape + per-class pixel counts."""
        body = self._request("/v1/segment", self._payload(frames))
        return json.loads(body)

    def reload(self) -> Dict:
        """Ask the server to re-read its checkpoint and swap weights in
        place (zero downtime, no recompile). Raises ServerError(409) when
        the on-disk tree no longer matches the serving model."""
        return json.loads(self._request("/v1/reload", b""))

    def healthz(self) -> Dict:
        return json.loads(self._request("/healthz"))

    def metrics(self) -> Dict:
        return json.loads(self._request("/metrics"))
