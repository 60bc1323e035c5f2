"""Prefetch: overlap host batch preparation and the host-to-device copy
with compute.

Port of ``odc_tpu/data/prefetch.py``.  The pipeline thread
(:func:`threaded_prefetch`) overlaps decoding with compute;
:func:`device_prefetch` additionally keeps ``depth`` batches in flight to
the device, copied from pinned memory with ``non_blocking=True``, so the
train step does not wait on the copy.
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator

import numpy as np
import torch


def _to_device(batch, device: torch.device):
    """A NamedTuple of numpy arrays -> the same NamedTuple of tensors on
    ``device``.  For a CUDA device each array is staged in pinned memory and
    copied asynchronously on the current stream."""
    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)

    return type(batch)(*(put(a) for a in batch))


def device_prefetch(
    batches: Iterable,
    device="cuda",
    depth: int = 2,
) -> Iterator:
    """Yield batches resident on ``device``, keeping ``depth`` in flight."""
    device = torch.device(device)
    queue: collections.deque = collections.deque()
    it = iter(batches)
    try:
        for _ in range(depth):
            queue.append(_to_device(next(it), device))
    except StopIteration:
        pass

    while queue:
        out = queue.popleft()
        try:
            queue.append(_to_device(next(it), device))
        except StopIteration:
            pass
        yield out


def threaded_prefetch(make_items, maxsize: int = 2) -> Iterator:
    """Run ``make_items()`` (an iterable factory) on a daemon thread,
    yielding its items through a bounded queue.

    Shutdown-safe: if the CONSUMER stops early (exception or break), the
    worker is signalled via a stop event and unblocked from its ``put`` —
    no leaked thread pinning ``maxsize`` buffers.  Worker exceptions
    re-raise in the consumer (unless the consumer is already unwinding its
    own exception)."""
    import queue as queue_mod
    import sys
    import threading

    q: "queue_mod.Queue" = queue_mod.Queue(maxsize=maxsize)
    stop = threading.Event()
    sentinel = object()
    errbox = []

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def worker():
        try:
            for item in make_items():
                if not _put(item):
                    return
        except BaseException as e:  # surfaced in the consumer thread
            errbox.append(e)
        finally:
            _put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
    finally:
        stop.set()
        t.join(timeout=10.0)
        # re-raise a worker error only when the consumer isn't already
        # propagating its own exception (incl. GeneratorExit from an early
        # close) — but never silently drop it: a real loader failure must
        # leave a trace even when the consumer is unwinding.
        if errbox:
            if sys.exc_info()[0] is None:
                raise errbox[0]
            import warnings

            warnings.warn(
                "threaded_prefetch: suppressed worker exception while the "
                f"consumer was unwinding: {errbox[0]!r}",
                RuntimeWarning,
            )
