"""Structured metrics (the port's own copy of ``odc_tpu/utils/metrics.py``):
per-step/epoch scalars as JSONL (machine-readable, append-only), an
images/sec meter on the host clock, an optional ``torch.profiler`` trace
context, and the program's own spans and counters.

Spans (:func:`span`, :func:`count`) are on exactly while a
``torch.profiler`` records (``profiler_trace``, or any other profiler) and
never under ``torch.compile`` or ``torch.export``.  Off, a span reads one
flag and returns a shared no-op: no allocation, no timestamp, no event.
On, a span records its name and attributes, its start and end on
``time.perf_counter()``, its parent, and the id of the ``infer`` call it
belongs to; on a card, a pair of timing CUDA events around it as well
(``sync`` spans, the host's waits for a blocking transfer, are host only).
The events come from a pool and are read once they have completed: while
the host waits in a ``sync`` span, or after a synchronise when the spans
are read (:func:`recorded_spans`).  Spans are never profiler ranges
(``record_function``): the profiler mirrors those onto the device timeline,
where they would read as device work.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler


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
    first = len(_TRACER.spans)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        stem = f"{os.getpid()}_{time.time_ns()}"
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{stem}.json"))
        spans = recorded_spans()[first:]
        if spans:
            export_spans(os.path.join(log_dir, f"spans_{stem}.jsonl"), spans)


class Span:
    """One recorded span: ``name``, ``attrs``, ``id`` (its index among the
    recorded spans), ``parent`` (the enclosing span's id or None),
    ``call`` (the id of the ``infer`` call it belongs to, or None),
    ``t0``/``t1`` (``time.perf_counter()``), ``counts`` (what
    :func:`count` added while it was the innermost span) and, once read on a
    card, ``device_ms`` (CUDA-event time from its start to its end on the
    stream; None for host-only spans and on the CPU)."""

    __slots__ = ("name", "attrs", "id", "parent", "call", "t0", "t1",
                 "counts", "device_ms", "_events")

    def __init__(self, name, attrs, sid, parent, call):
        self.name, self.attrs, self.id = name, attrs, sid
        self.parent, self.call = parent, call
        self.t0 = self.t1 = None
        self.counts = self.device_ms = self._events = None

    @property
    def host_ms(self) -> float:
        return (self.t1 - self.t0) * 1e3

    def __enter__(self):
        _TRACER.enter(self)
        return self

    def __exit__(self, *exc):
        _TRACER.exit(self)
        return False

    def record(self) -> dict:
        return {"id": self.id, "name": self.name, "parent": self.parent,
                "call": self.call, "t0": self.t0, "t1": self.t1,
                "host_ms": self.host_ms, "device_ms": self.device_ms,
                "attrs": self.attrs or {}, "counts": self.counts or {}}


# The shared span of a process that records nothing (a nullcontext:
# dynamo traces through it).
_NO_SPAN = contextlib.nullcontext()
CALL = "infer"  # a span of this name opens a call: its spans share its id
HOST_ONLY = "sync"  # a span of this name takes no CUDA events
MAX_PENDING = 4096  # spans whose events may wait for a sync span's read


class _Tracer:
    """The spans of the process, the open ones per thread, and the pool of
    timing events."""

    def __init__(self) -> None:
        self.spans: List[Span] = []
        self.calls = itertools.count()
        self.local = threading.local()
        self.pending: List[Span] = []  # spans whose events are unread
        self.free: list = []  # events ready for reuse
        self.lock = threading.Lock()

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def open(self, name: str, attrs: dict) -> Span:
        st = self.stack()
        top = st[-1] if st else None
        call = next(self.calls) if name == CALL else (
            top.call if top is not None else None)
        with self.lock:
            sp = Span(name, attrs or None, len(self.spans),
                      None if top is None else top.id, call)
            self.spans.append(sp)
        return sp

    def _event(self):
        try:
            return self.free.pop()
        except IndexError:
            return torch.cuda.Event(enable_timing=True)

    def enter(self, sp: Span) -> None:
        self.stack().append(sp)
        sp.t0 = time.perf_counter()
        if sp.name == HOST_ONLY:
            # While the host waits anyway: the spans of earlier calls (the
            # current call's would be read after its work, with the device
            # idle).
            self.resolve(keep_call=sp.call)
        elif (torch.cuda.is_initialized()
              and not torch.cuda.is_current_stream_capturing()):
            if sp.name == CALL and len(self.pending) > MAX_PENDING:
                self.resolve()  # calls without a sync span
            stream = torch.cuda.current_stream()
            ev = self._event()
            ev.record(stream)
            sp._events = (ev, stream)

    def exit(self, sp: Span) -> None:
        if sp._events is not None:
            start, stream = sp._events
            ev = self._event()
            ev.record(stream)
            sp._events = (start, ev)
            self.pending.append(sp)
        sp.t1 = time.perf_counter()
        st = self.stack()
        if st and st[-1] is sp:
            st.pop()

    def resolve(self, keep_call=None) -> None:
        """Read the events of the pending spans that have completed, in
        the order they ended, up to the first of call ``keep_call`` (if
        not None); return the events to the pool."""
        with self.lock:
            done = 0
            for sp in self.pending:
                start, end = sp._events
                if (keep_call is not None and sp.call == keep_call) or (
                        not end.query()):
                    break
                sp.device_ms = start.elapsed_time(end)
                sp._events = None
                self.free += (start, end)
                done += 1
            del self.pending[:done]

    def reset(self) -> None:
        with self.lock:
            self.spans = []
            self.pending = []
            self.calls = itertools.count()


_TRACER = _Tracer()


def profiling() -> bool:
    """Whether a ``torch.profiler`` records: the flag :func:`span` and
    :func:`count` read."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str, **attrs):
    """Context manager: a span named ``name`` with ``attrs`` while a
    ``torch.profiler`` records; otherwise (and under ``torch.compile`` or
    ``torch.export``) a shared no-op."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    if torch.compiler.is_compiling():
        return _NO_SPAN
    return _TRACER.open(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span (nothing
    when no span records)."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    st = _TRACER.stack()
    if st:
        counts = st[-1].counts
        if counts is None:
            counts = st[-1].counts = {}
        counts[name] = counts.get(name, 0) + n


def recorded_spans() -> List[Span]:
    """Every span recorded since the last :func:`reset_spans`, in the order
    they started; on a card, after a synchronise, with their device ms."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    _TRACER.resolve()
    return list(_TRACER.spans)


def spans_by_call() -> Dict[int, List[Span]]:
    """:func:`recorded_spans` of each ``infer`` call, by the call's id."""
    out: Dict[int, List[Span]] = {}
    for sp in recorded_spans():
        if sp.call is not None:
            out.setdefault(sp.call, []).append(sp)
    return out


def counters(spans: List[Span]) -> Dict[str, int]:
    """Each counter summed over ``spans``."""
    out: Dict[str, int] = {}
    for sp in spans:
        for k, v in (sp.counts or {}).items():
            out[k] = out.get(k, 0) + v
    return out


def reset_spans() -> None:
    """Forget the recorded spans (events still pending are dropped)."""
    _TRACER.reset()


def export_spans(path: str, spans: List[Span]) -> None:
    """Write ``spans`` as JSONL, one object a span, then one
    ``{"counters": ...}`` line."""
    with open(path, "w") as f:
        for sp in spans:
            f.write(json.dumps(sp.record()) + "\n")
        f.write(json.dumps({"counters": counters(spans)}) + "\n")
