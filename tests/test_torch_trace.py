"""The port's spans and counters (``odc_tpu_torch/utils/metrics.py``) on the
CPU: nothing recorded without a profiler, the span tree of a bulk ``infer``
call under one, outputs and the exported engine unchanged by them, the
JSONL export beside ``profiler_trace``'s Chrome trace, and the benchmark's
span metrics on hand-built spans.

One YOLOv2 and one YOLOv3 at 64x64, batch 1, built once (module fixture).
No JAX: the tracer has no counterpart in the JAX package.
"""

import json

import pytest
import torch
from torch.profiler import profile

from benchmark import harness
from odc_tpu_torch.models import YOLOv2, YOLOv3
from odc_tpu_torch.models.layers import ConvBnLeaky
from odc_tpu_torch.ops.detect import make_infer_fn
from odc_tpu_torch.serve.engine import _Program, _scalar
from odc_tpu_torch.utils import metrics

HW = (64, 64)
IMAGES = torch.randint(0, 256, (1, *HW, 3), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(0))
# The sync sites a call passes: none.  The normalize's and decode's
# constants are made once per device (core/constants.py) and the NMS sort
# masks with a scalar, so no copy blocks inside a call.
SYNC_SITES = {"yolov2": [], "yolov3": []}


@pytest.fixture(scope="module")
def nets():
    torch.manual_seed(0)
    out = {}
    for name, cls in (("yolov2", YOLOv2), ("yolov3", YOLOv3)):
        model = cls(dtype=torch.bfloat16, device="cpu", image_size=HW, seed=1)
        out[name] = (model, make_infer_fn(model, 0.0, 0.5, 16, compact=True))
    return out


@pytest.fixture
def no_events(monkeypatch):
    """Every CUDA event the tracer would create, counted."""
    made = []
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **k: made.append(1))
    metrics.reset_spans()
    yield made
    metrics.reset_spans()


def _conv_blocks_run(model, fn):
    """``fn()`` and the number of ConvBnLeaky forwards it ran."""
    runs = []
    hooks = [m.register_forward_hook(lambda *_: runs.append(1))
             for m in model.modules() if isinstance(m, ConvBnLeaky)]
    try:
        return fn(), len(runs)
    finally:
        for h in hooks:
            h.remove()


@pytest.mark.parametrize("name", ["yolov2", "yolov3"])
def test_spans_off_then_on(nets, no_events, name):
    """Without a profiler a call records nothing and makes no event; under
    one it records the call's span tree, with the same outputs."""
    model, infer = nets[name]
    assert metrics.span("conv") is metrics.span("sync", site="x")
    off = infer(IMAGES)
    assert metrics.recorded_spans() == [] and not no_events
    with profile():
        on, blocks = _conv_blocks_run(model, lambda: infer(IMAGES))
    assert all(torch.equal(a, b) for a, b in zip(off, on))  # bitwise

    spans = metrics.recorded_spans()
    assert not no_events  # the CPU takes no CUDA events
    (root,) = [sp for sp in spans if sp.name == "infer"]
    assert root.parent is None and root.counts == {"images": 1}
    assert {sp.call for sp in spans} == {root.call}
    by_id = {sp.id: sp for sp in spans}
    parent = {sp.id: by_id[sp.parent].name if sp.parent is not None else None
              for sp in spans}
    names = [sp.name for sp in spans]
    assert names.count("conv") == names.count("bn_leaky") == blocks > 0
    for sp in spans:
        assert sp.t0 <= sp.t1 and sp.device_ms is None
        if sp.name in ("conv", "bn_leaky", "decode", "nms"):
            assert parent[sp.id] == "infer", sp.name
    sync = [sp for sp in spans if sp.name == "sync"]
    assert [sp.attrs["site"] for sp in sync] == SYNC_SITES[name]


def test_export_is_unchanged_under_a_profiler(nets, no_events):
    """``torch.export`` traces through the spans as no-ops: the serving
    engine's program is the same with a profiler recording."""
    model, infer = nets["yolov2"]
    args = (torch.zeros(1, *HW, 3, dtype=torch.uint8), _scalar(0.5),
            _scalar(0.5))
    plain = torch.export.export(_Program(model, infer), args)
    with profile():
        traced = torch.export.export(_Program(model, infer), args)
    assert traced.graph_module.code == plain.graph_module.code
    assert metrics.recorded_spans() == []


def test_profiler_trace_writes_the_spans_beside_the_trace(tmp_path, no_events):
    block = ConvBnLeaky(3, 4, dtype=torch.float32).eval()
    with metrics.profiler_trace(str(tmp_path)):
        with metrics.span("infer"):
            metrics.count("images", 2)
            block(torch.ones(2, 8, 8, 3))
    (jsonl,) = tmp_path.glob("spans_*.jsonl")
    assert len(list(tmp_path.glob("trace_*.json"))) == 1
    lines = [json.loads(s) for s in jsonl.read_text().splitlines()]
    assert [r.get("name") for r in lines[:-1]] == ["infer", "conv", "bn_leaky"]
    assert [r["parent"] for r in lines[:-1]] == [None, 0, 0]
    assert {r["call"] for r in lines[:-1]} == {lines[0]["call"]}
    assert lines[0]["counts"] == {"images": 2}
    assert lines[-1] == {"counters": {"images": 2}}


class _FakeEvent:
    """A timing event whose clock is the number of records so far."""

    clock = 0
    made = 0

    def __init__(self, enable_timing):
        assert enable_timing
        _FakeEvent.made += 1

    def record(self, stream):
        _FakeEvent.clock += 1
        self.t = _FakeEvent.clock

    def query(self):
        return True

    def elapsed_time(self, end):
        return float(end.t - self.t)


def test_events_are_pooled_and_read_while_a_sync_waits(monkeypatch):
    """The card's path with a stand-in for CUDA: two events a device span,
    none for ``sync``; a call's events are read at the next call's first
    ``sync`` (or when the spans are read) and then reused."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(_FakeEvent, "made", 0)
    metrics.reset_spans()

    def call():
        with metrics.span("infer"):
            with metrics.span("conv"):
                pass
            with metrics.span("sync", site="s"):
                pass
            with metrics.span("bn_leaky"):
                pass

    with profile():
        call()
        assert _FakeEvent.made == 6 and len(metrics._TRACER.pending) == 3
        call()  # its sync reads the first call's three spans
        assert _FakeEvent.made == 9 and len(metrics._TRACER.pending) == 3
        call()
        assert _FakeEvent.made == 9  # from the pool
    spans = metrics.recorded_spans()
    assert [sp.call for sp in spans] == [0] * 4 + [1] * 4 + [2] * 4
    assert [sp.device_ms for sp in spans[:4]] == [5.0, 1.0, None, 1.0]
    assert all(sp.device_ms is not None for sp in spans if sp.name != "sync")
    metrics.reset_spans()


def _span(sid, name, parent, t0, t1, device_ms=None, **attrs):
    sp = metrics.Span(name, attrs or None, sid, parent, 0)
    sp.t0, sp.t1, sp.device_ms = t0, t1, device_ms
    return sp


# Two calls by hand (seconds): infer > [conv, bn_leaky] x 2, decode > sync,
# nms > sync; the second call twice as slow throughout.
def _call(k):
    return [
        _span(0, "infer", None, 0.0, 0.030 * k),
        _span(1, "conv", 0, 0.000, 0.001, 2.0 * k),
        _span(2, "bn_leaky", 0, 0.001, 0.002, 5.0 * k),
        _span(3, "conv", 0, 0.002, 0.003, 1.0 * k),
        _span(4, "bn_leaky", 0, 0.003, 0.004, 3.0 * k),
        _span(5, "sync", 0, 0.004, 0.005 * k, site="a"),
        _span(6, "decode", 0, 0.010, 0.020 * k),
        _span(7, "sync", 6, 0.010, 0.016 * k, site="b"),
        _span(8, "nms", 0, 0.020 * k, 0.024 * k),
        _span(9, "sync", 8, 0.020 * k, 0.021 * k, site="c"),
    ]


@pytest.mark.parametrize("metric, want", [
    ("conv_ms.infer", 4.5),            # median of 3 and 6
    ("bn_leaky_ms.infer", 12.0),       # of 8 and 16
    ("host_wait_ms.infer", 19.0),      # of (1 + 6 + 1) and (6 + 22 + 2)
    ("host_syncs.infer", 3),
    ("decode_nms_host_ms.infer", 10.5),  # of (10 + 4 - 6 - 1) and 14
])
def test_benchmark_span_metrics_on_hand_built_spans(monkeypatch, metric, want):
    calls = {0: _call(1), 1: _call(2)}
    monkeypatch.setattr(metrics, "spans_by_call", lambda: calls)
    mod = harness.load_module("metrics", metric)
    assert mod.read(None) == pytest.approx(want)


def test_benchmark_span_metrics_are_silent_without_spans(monkeypatch):
    monkeypatch.setattr(metrics, "spans_by_call", lambda: {})
    for name in ("conv_ms.infer", "host_wait_ms.infer", "host_syncs.infer"):
        assert harness.load_module("metrics", name).read(None) is None
    # Device times on the CPU: none.
    cpu = {0: [_span(0, "infer", None, 0.0, 1.0),
               _span(1, "conv", 0, 0.0, 0.5)]}
    monkeypatch.setattr(metrics, "spans_by_call", lambda: cpu)
    assert harness.load_module("metrics", "conv_ms.infer").read(None) is None
    assert harness.load_module("metrics", "decode_nms_host_ms.infer").read(
        None) is None
