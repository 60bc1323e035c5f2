"""Serving front end: micro-batching over a loaded ``ServingEngine``.

Port of ``odc_tpu/serve/server.py``.  The reference serves one synchronous
``detect(img)`` per image in a live process; batch assembly is the
caller's problem and a batch of one leaves the card almost idle.  The
device batch is the throughput knob, so the serving host needs a request
coalescer.

:class:`BatchingServer` wraps a loaded
:class:`~odc_tpu_torch.serve.engine.ServingEngine` with a queue and one
worker thread, which alone calls the engine (and so launches on the card):

* callers ``submit()`` single images (any thread) and get a
  ``concurrent.futures.Future`` back;
* the worker coalesces up to ``max_batch`` requests that share an
  operating point (conf/iou thresholds are per-BATCH scalars of the
  program), flushing early when ``max_delay_ms`` expires so tail latency is
  bounded;
* fixed-batch engines pad partial batches (the engine already trims);
  symbolic-batch engines are padded UP to a bounded ``bucket_sizes`` ladder,
  so the device sees a finite set of batch shapes under arbitrary traffic.

FIFO order is preserved across operating points: a request with a
different (conf, iou) flushes the batch in front of it rather than jumping
the queue.

There is no RPC framework here: transport is the host integrator's choice.
A minimal stdlib HTTP wrapper lives in :mod:`odc_tpu_torch.serve.httpd`.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from odc_tpu_torch.serve.engine import ServingEngine, _annot_of

__all__ = ["BatchingServer"]


class _Request:
    __slots__ = ("image", "conf", "iou", "future")

    def __init__(self, image, conf, iou):
        self.image = image
        self.conf = conf
        self.iou = iou
        self.future: Future = Future()

    @property
    def op_point(self) -> Tuple[Optional[float], Optional[float]]:
        return (self.conf, self.iou)


def _default_buckets(max_batch: int) -> Tuple[int, ...]:
    sizes = []
    b = 1
    while b < max_batch:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch)
    return tuple(sizes)


class BatchingServer:
    """Micro-batching request coalescer over a :class:`ServingEngine`.

    Parameters
    ----------
    engine:
        A loaded engine (fixed or symbolic batch).
    max_batch:
        Largest batch handed to the device per step.  Defaults to the
        engine's compiled batch; REQUIRED for symbolic-batch engines.
    max_delay_ms:
        How long the worker waits for more requests after the first one
        of a batch arrives before flushing a partial batch.
    bucket_sizes:
        Symbolic-batch engines only: allowed device batch sizes; a
        partial batch is zero-padded up to the next bucket (outputs
        trimmed on the host).  Defaults to powers of two up to
        ``max_batch``.  Fixed-batch engines ignore this — the engine
        itself pads to its one compiled size.
    """

    def __init__(
        self,
        engine: ServingEngine,
        *,
        max_batch: Optional[int] = None,
        max_delay_ms: float = 5.0,
        bucket_sizes: Optional[Sequence[int]] = None,
    ) -> None:
        self.engine = engine
        compiled = engine.batch_size
        if max_batch is None:
            if compiled is None:
                raise ValueError(
                    "symbolic-batch engine: max_batch is required (it bounds "
                    "the ladder of device batch shapes)"
                )
            max_batch = compiled
        if compiled is not None and max_batch > compiled:
            raise ValueError(
                f"max_batch {max_batch} exceeds the engine's compiled batch "
                f"{compiled}"
            )
        self.max_batch = int(max_batch)
        self.max_delay = max_delay_ms / 1e3
        if compiled is None:
            buckets = (
                _default_buckets(self.max_batch)
                if bucket_sizes is None
                else tuple(sorted(set(int(b) for b in bucket_sizes)))
            )
            if not buckets or buckets[-1] < self.max_batch:
                raise ValueError("bucket_sizes must cover max_batch")
            if any(b <= 0 for b in buckets):
                raise ValueError("bucket_sizes must be positive")
            self._buckets: Optional[Tuple[int, ...]] = buckets
        else:
            self._buckets = None

        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._carry: Optional[_Request] = None  # op-point flush holdover
        self._worker: Optional[threading.Thread] = None
        self._stopping = False
        # Observability: device steps, images served, per-step batch sizes.
        self.stats: Dict = {"batches": 0, "images": 0, "batch_sizes": []}

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "BatchingServer":
        if self._worker is not None:
            raise RuntimeError("already started")
        self._stopping = False
        self._worker = threading.Thread(
            target=self._run, name="odc-serve-batcher", daemon=True
        )
        self._worker.start()
        return self

    def stop(self) -> None:
        """Drain outstanding requests, then stop the worker."""
        if self._worker is None:
            return
        self._stopping = True
        self._queue.put(None)  # wake the worker if idle
        self._worker.join()
        self._worker = None

    def __enter__(self) -> "BatchingServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- client surface ----------------------------------------------------

    def submit(
        self,
        image: np.ndarray,
        conf_thre: Optional[float] = None,
        iou_thre: Optional[float] = None,
    ) -> Future:
        """Enqueue one [H,W,3] uint8 image; resolves to the per-image
        engine output tuple (each engine output, batch dim stripped)."""
        if self._worker is None or self._stopping:
            raise RuntimeError("server is not running")
        image = np.asarray(image)
        h, w = self.engine.manifest["image_hw"]
        if image.shape != (h, w, 3) or image.dtype != np.uint8:
            raise ValueError(
                f"expected one [{h}, {w}, 3] uint8 image, got {image.dtype} "
                f"{image.shape}"
            )
        req = _Request(image, conf_thre, iou_thre)
        self._queue.put(req)
        return req.future

    def predict_one(self, image, conf_thre=None, iou_thre=None):
        """Blocking convenience: submit + wait."""
        return self.submit(image, conf_thre, iou_thre).result()

    def predict_annot(self, image, conf_thre=None, iou_thre=None) -> Dict:
        """Blocking single-image annot dict (the reference ``detect()``
        output contract)."""
        outs = self.predict_one(image, conf_thre, iou_thre)
        return _annot_of(self.engine.manifest, outs)

    # -- worker ------------------------------------------------------------

    def _next_batch(self) -> Optional[List[_Request]]:
        """Block for the first request, then coalesce same-op-point
        requests until max_batch or the delay budget runs out."""
        first = self._carry
        self._carry = None
        if first is None:
            first = self._queue.get()
            if first is None:  # stop sentinel
                return None
        batch = [first]
        deadline = time.monotonic() + self.max_delay
        while len(batch) < self.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                req = self._queue.get(timeout=timeout)
            except queue.Empty:
                break
            if req is None:
                # Stop requested: flush what we have; _run re-reads the
                # now-empty queue and exits after the drain.
                self._queue.put(None)
                break
            if req.op_point != first.op_point:
                # Different thresholds can't share the compiled batch's
                # scalar args; serve it next round to keep FIFO.
                self._carry = req
                break
            batch.append(req)
        return batch

    def _run(self) -> None:
        while True:
            batch = self._next_batch()
            if batch is None:
                # Stop sentinel consumed.  A request can legally sit BEHIND
                # it (submit raced stop()): re-arm the sentinel and keep
                # draining, else join() would wait on a worker blocked in
                # queue.get() forever.
                if self._carry is None and self._queue.empty():
                    return
                self._queue.put(None)
                continue
            self._serve(batch)

    def _serve(self, batch: List[_Request]) -> None:
        # PENDING -> RUNNING transition: after this, a client cancel() can
        # no longer race our set_result into InvalidStateError.  A request
        # cancelled while queued still occupies its batch slot (cheap).
        running = [r.future.set_running_or_notify_cancel() for r in batch]
        images = np.stack([r.image for r in batch], 0)
        n = images.shape[0]
        if self._buckets is not None:
            bucket = next(b for b in self._buckets if b >= n)
            if bucket > n:
                pad = np.zeros((bucket - n,) + images.shape[1:], np.uint8)
                images = np.concatenate([images, pad], 0)
        try:
            outs = self.engine.predict(images, batch[0].conf, batch[0].iou)
        except Exception as e:  # a failed call fails the whole batch
            for r, live in zip(batch, running):
                if live:
                    r.future.set_exception(e)
            return
        self.stats["batches"] += 1
        self.stats["images"] += n
        sizes = self.stats["batch_sizes"]
        sizes.append(n)
        if len(sizes) > 1000:  # long-running hosts: bound the trace
            del sizes[:-1000]
        for i, (r, live) in enumerate(zip(batch, running)):
            if live:
                r.future.set_result(tuple(o[i] for o in outs))

