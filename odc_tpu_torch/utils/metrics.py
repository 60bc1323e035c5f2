"""Structured metrics (the port's own copy of ``odc_tpu/utils/metrics.py``):
per-step/epoch scalars as JSONL (machine-readable, append-only), an
images/sec meter on the host clock, and an optional ``torch.profiler`` trace
context.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import torch


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


class Throughput:
    """images/sec meter on the host clock, with warmup exclusion: the
    clock starts at :meth:`start` (call it after the warm-up), and
    :meth:`update` counts the images done since.  On a card, synchronize
    before reading :attr:`images_per_sec`: PyTorch returns before the
    device finishes."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._t0 = None
        self._images = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()
        self._images = 0

    def update(self, n_images: int) -> None:
        self._images += n_images

    @property
    def images_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._images / dt if dt > 0 else 0.0


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """``torch.profiler`` trace context: records the body (CPU activity,
    and CUDA activity when a card is present) and writes a Chrome trace,
    ``trace_<pid>_<ns>.json``, into ``log_dir`` (created if missing) at
    exit; a no-op when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
