"""What every cell shares: finding cells, configurations and metrics by
name, host spans, the profiler's reduction, and the result line.

A cell is ``workloads/<name>.json``; its configuration ``configs/<name>.json``;
its traffic driver ``drivers/<kind>.py``; every per-layer metric
``metrics/<name>.py``.  Nothing here lists them: a later cell, configuration,
driver or metric is a new file.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib.util
import json
import pathlib
import statistics
import time
from dataclasses import dataclass, field
from types import ModuleType
from typing import Dict, List, Optional, Tuple

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
# Top-level module names that may never be loaded in a run (compared whole:
# the port's name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "odc_tpu")


def load_json(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under the benchmark's folder."""
    path = BENCH / kind / f"{name}.json"
    with open(path) as f:
        data = json.load(f)
    if data.get("name") != name:
        raise ValueError(f"{path}: name {data.get('name')!r} is not {name!r}")
    return data


def names(kind: str, suffix: str = ".json") -> List[str]:
    return sorted(p.name[:-len(suffix)] for p in (BENCH / kind).glob("*" + suffix)
                  if not p.name.startswith("_"))


def load_module(kind: str, name: str) -> ModuleType:
    """``<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(cell: str) -> Dict[str, ModuleType]:
    """Every per-layer metric that lists ``cell``."""
    out = {}
    for name in names("metrics", ".py"):
        mod = load_module("metrics", name)
        if cell in mod.WORKLOADS:
            out[name] = mod
    return out


def sub_seed(seed: int, k: int) -> int:
    """A derived seed for the ``k``-th use of ``seed``."""
    return (int(seed) * 1_000_003 + k) % (1 << 62)


def forbidden_modules(modules) -> List[str]:
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


@contextlib.contextmanager
def ieee_f32():
    """TF32 off for matmuls and cuDNN convolutions (the reference's f32)."""
    import torch

    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class Recorder:
    """Host spans of the benchmark's own calls into the program, from any
    thread: name -> [(start, end)] on ``time.perf_counter``, kept in traced
    runs only.  A traced run labels each device gap with the span open in
    its middle."""

    def __init__(self, trace: bool):
        self.trace = trace
        self.spans: Dict[str, List[Tuple[float, float]]] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.trace:  # the spans are read in traced runs only
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.setdefault(name, []).append((t0, time.perf_counter()))

    def durations_ms(self, name: str) -> List[float]:
        return [(b - a) * 1e3 for a, b in self.spans.get(name, [])]


@dataclass
class Trace:
    """What a traced run hands the per-layer metrics."""

    cell: dict
    config: dict
    window_s: float
    window_t0: float = 0.0  # time.perf_counter() at the window's start
    busy_s: float = 0.0
    kernels: Dict[str, Tuple[float, int]] = field(default_factory=dict)  # name -> (s, count)
    recorder: Optional[Recorder] = None
    counters: Dict[str, float] = field(default_factory=dict)
    device_ms: Dict[str, List[float]] = field(default_factory=dict)
    values: Dict[str, float] = field(default_factory=dict)
    breakdown: dict = field(default_factory=dict)

    def kernel_s(self, fragment: str) -> Tuple[float, int]:
        """Device seconds and launches of every kernel whose name holds
        ``fragment``."""
        s = n = 0
        for name, (sec, cnt) in self.kernels.items():
            if fragment in name:
                s += sec
                n += cnt
        return s, n


def median(xs) -> Optional[float]:
    xs = list(xs)
    return statistics.median(xs) if xs else None


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def reduce_profile(prof, trace: Trace) -> None:
    """Fill ``trace`` from a stopped ``torch.profiler.profile`` whose body
    was one ``record_function("window")``: device seconds by operation,
    busy seconds (the union of device intervals, not their sum), and the
    idle gaps by the recorder's host span open at their middle (the
    window's start ties the host clock to the profiler's)."""
    from torch.autograd import DeviceType

    dev, w0, w1 = [], None, None
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() * 1e-9
        end = start + e.duration_ns() * 1e-9
        if e.name() == "window":
            if e.device_type() != DeviceType.CUDA:
                w0, w1 = start, end
        elif e.device_type() == DeviceType.CUDA:
            dev.append((start, end, e.name()))
    if w0 is None:
        raise RuntimeError("the profiler recorded no window span")
    kernels: Dict[str, list] = {}
    clipped = []
    for a, b, name in dev:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        clipped.append((a, b))
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += b - a
        k[1] += 1
    trace.kernels = {k: (v[0], v[1]) for k, v in kernels.items()}
    merged = _merge(clipped)
    trace.busy_s = sum(b - a for a, b in merged)
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    shift = w0 - trace.window_t0
    spans = sorted((a + shift, b + shift, name)
                   for name, ab in (trace.recorder.spans if trace.recorder else {}).items()
                   for a, b in ab)
    starts = [sp[0] for sp in spans]
    by_label: Dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) / 2
        label = "other"
        # The latest-starting span that is still open at ``mid``.
        for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if spans[j][1] >= mid:
                label = spans[j][2]
                break
            if mid - spans[j][0] > 1.0:  # no span is that long
                break
        by_label[label] = by_label.get(label, 0.0) + (b - a)
    ops = sorted(trace.kernels.items(), key=lambda kv: -kv[1][0])[:10]
    trace.breakdown = {
        "device_ops": [[name, sec] for name, (sec, _) in ops],
        "idle_gaps": sorted(([k, v] for k, v in by_label.items()),
                            key=lambda kv: -kv[1])[:10],
    }


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: Dict[str, Tuple[float, float]],
                breakdown: Optional[dict] = None) -> str:
    """The run's last line of standard output: the driver's keys, the
    compared numbers last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return json.dumps(out)
