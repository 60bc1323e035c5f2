"""Structured metrics (the port's own copy of ``odc_tpu/utils/metrics.py``):
per-step/epoch scalars as JSONL (machine-readable, append-only).
"""

from __future__ import annotations

import json
import time
from typing import Optional


class JsonlLogger:
    def __init__(self, path: Optional[str]) -> None:
        self.path = path
        self._fh = open(path, "a") if path else None

    def write(self, **record) -> None:
        record.setdefault("time", time.time())
        if self._fh is not None:
            self._fh.write(json.dumps(record) + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
