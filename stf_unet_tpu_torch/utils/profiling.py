"""Structured training metrics (counterpart of
stf_unet_tpu/utils/profiling.py).

Only the JSONL writer is ported: cli/train writes one record per epoch
to `<model>_metrics_<stamp><tag>.jsonl` beside the parity results .txt.
The JAX module's profiler trace and annotations are not ported yet
(ROADMAP.md §1, 'long tail').
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


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
