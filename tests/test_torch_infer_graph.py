"""A whole ``make_infer_fn`` call replayed as one CUDA graph
(``odc_tpu_torch/ops/detect.py``), and the constants that let a call be
captured (``odc_tpu_torch/core/constants.py``).

On the CPU: a YOLOv2, YOLOv3 and YOLOv4 call at 64x64 passes no ``sync``
span and returns bitwise what it returned when decode, the normalize and
the NMS sort made their constants on every call; the CPU, a profiler and
``torch.export`` keep the call eager.  On a card (skipped without one; run
there with ``python -m pytest --noconftest tests/test_torch_infer_graph.py
-k card``), at each bulk cell's model and weights with a batch of 2: the
graphed call bitwise the eager call over distinct images, a returned output
untouched by the next call, a new threshold captured as a new key, kernel
launches counted per replay as per eager call, ``torch.export`` of a
function that holds graphs capturing nothing, and an eager call with its
spans under a profiler; a function past ``GRAPH_KEYS`` keys eager for good,
and a sharded model never graphed.  This file imports no JAX."""

import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from benchmark.reference import calibrate
from odc_tpu_torch.core import constants, image, nms
from odc_tpu_torch.models import get_model
from odc_tpu_torch.ops import decode
from odc_tpu_torch.ops.cuda import build
from odc_tpu_torch.ops.cuda.nms_kernel import suppress
from odc_tpu_torch.ops.detect import GRAPH_KEYS, make_infer_fn
from odc_tpu_torch.serve.engine import _Program, _scalar
from odc_tpu_torch.utils import metrics

BF16 = torch.bfloat16
HW = (64, 64)


def _images(n, hw, seed, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, *hw, 3), generator=gen,
                         dtype=torch.uint8).to(device)


def _per_call(values, dtype, device):
    """How decode and the normalize made their constants before: a new
    tensor (a blocking copy on a card) every call."""
    return torch.tensor(values, dtype=dtype, device=device)


def _per_call_sorted_candidates(boxes, score, valid, max_keep):
    """``core/nms.py::sorted_candidates`` as it masked with a -inf tensor
    made every call."""
    n = boxes.shape[1]
    k = min(max_keep, n)
    neg_inf = torch.tensor(float("-inf"), dtype=score.dtype,
                           device=score.device)
    score = torch.where(valid, score, neg_inf)
    top_score, order = torch.sort(score, dim=-1, descending=True, stable=True)
    order = order[:, :k]
    if k < n:
        survivors = top_score[:, :k] > neg_inf
    else:
        survivors = valid.gather(1, order)
    return (order, nms._gather_rows(boxes, order).contiguous(),
            survivors.contiguous())


@pytest.mark.parametrize("name", ["YOLOv2", "YOLOv3", "YOLOv4"])
def test_a_call_blocks_on_no_copy_and_keeps_its_outputs(monkeypatch, name):
    """No ``sync`` span in a traced call; at a threshold that keeps every
    candidate and at one that drops half, the outputs are bitwise those of
    constants made every call."""
    model = get_model(name, dtype=BF16, device="cpu", image_size=HW, seed=1)
    infer = make_infer_fn(model, 0.0, 0.5, 16, compact=True)
    images = _images(1, HW, seed=3)
    with torch.no_grad():
        conf = model.decode(model(images), HW).conf
    thresholds = (0.0, float(conf.float().median()))
    metrics.reset_spans()
    try:
        with profile():
            now = [infer(images, conf_thre=t) for t in thresholds]
        names = [sp.name for sp in metrics.recorded_spans()]
    finally:
        metrics.reset_spans()
    assert names.count("infer") == 2 and "sync" not in names
    monkeypatch.setattr(decode, "device_constant", _per_call)
    monkeypatch.setattr(image, "device_constant", _per_call)
    monkeypatch.setattr(nms, "sorted_candidates", _per_call_sorted_candidates)
    for t, out in zip(thresholds, now):
        before = infer(images, conf_thre=t)
        assert all(torch.equal(a, b) for a, b in zip(out, before)), t
    assert all(int(out[-1].sum()) > 0 for out in now)


def test_device_constant_is_made_once_per_key():
    a = constants.device_constant(((1.0, 2.0), (3.0, 4.0)), torch.float32, "cpu")
    b = constants.device_constant([[1, 2], [3, 4]], torch.float32,
                                  torch.device("cpu"))
    assert a is b and a.shape == (2, 2)
    assert constants.device_constant((1.0, 2.0), BF16, "cpu").dtype == BF16
    with torch.inference_mode():
        c = constants.device_constant((5.0, 6.0), torch.float32, "cpu")
    assert not c.is_inference()  # training code may save it for backward


def test_the_cpu_a_profiler_and_export_keep_the_call_eager():
    model = get_model("YOLOv2", dtype=BF16, device="cpu", image_size=HW, seed=1)
    infer = make_infer_fn(model, 0.5, 0.5, 16, compact=True)
    images = _images(1, HW, seed=4)
    for _ in range(3):
        infer(images)
    with profile():
        infer(images)
    metrics.reset_spans()
    torch.export.export(_Program(model, infer),
                        (images, _scalar(0.5), _scalar(0.5)))
    assert (infer.graph_captures, infer.graph_replays) == (0, 0)


# -- on the card -----------------------------------------------------------

CELLS = ["yolov2-416.bulk-b64", "yolov3-416.bulk-b256", "yolov4-608.bulk-b64"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "--noconftest tests/test_torch_infer_graph.py -k card)")
    return "cuda"


def _cell_model(name, device):
    """The cell's model with the weights and BN calibration a run of seed
    2**31 + 11 makes, its configuration and its traffic."""
    cell = harness.load_json("workloads", name)
    cfg = harness.load_json("configs", cell["config"])
    driver = harness.load_module("drivers", cell["driver"])
    ctx = types.SimpleNamespace(cell=cell, cfg=cfg, seed=2**31 + 11,
                                device=device, mark=lambda name: None)
    return driver.program_model(cfg, driver.prepare(ctx), device), cfg, cell


class _Eager:
    """A no-op forward pre-hook on the model: the calls run eagerly."""

    def __init__(self, model):
        self.model = model

    def __enter__(self):
        self.handle = self.model.register_forward_pre_hook(lambda *a: None)

    def __exit__(self, *exc):
        self.handle.remove()


def _launches():
    return [k.launches for k in build.COUNTED]


def _call(infer, *args, **kw):
    """Outputs and each kernel's launches of one call."""
    before = _launches()
    out = infer(*args, **kw)
    torch.cuda.synchronize()
    return out, [a - b for a, b in zip(_launches(), before)]


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("name", CELLS)
def test_card_graphed_call_is_the_eager_call(card, name):
    model, cfg, cell = _cell_model(name, card)
    hw, t = tuple(cfg["image_size"]), cell["mix"]
    images = [_images(2, hw, seed=20 + i, device=card) for i in range(4)]
    with torch.no_grad():
        conf = model.decode(model(images[0]), hw).conf
    thr = calibrate.gap_threshold(conf, 8 * 2, 48 * 2)
    infer = make_infer_fn(model, thr, t["iou_thre"], t["max_keep"],
                          compact=True)
    with _Eager(model):
        want = [_call(infer, x) for x in images]
    launches = want[0][1]
    assert launches[build.COUNTED.index(suppress)] == 1
    assert all(w[1] == launches for w in want)
    assert (infer.graph_captures, infer.graph_replays) == (0, 0)

    # Warm-up (eager), capture, replay, replay.
    got = [_call(infer, x) for x in images]
    assert (infer.graph_captures, infer.graph_replays) == (1, 2)
    assert all(g[1] == launches for g in got)
    # Each output against the eager call's after every call has run: a
    # replay overwriting an output it returned before would show here.
    assert not _equal(want[2][0], want[3][0])
    for i, (g, w) in enumerate(zip(got, want)):
        assert _equal(g[0], w[0]), i
    assert bool(got[0][0][-1].any())

    # Another threshold: a new key, eager once, then captured.
    thr2 = calibrate.gap_threshold(conf, 48 * 2, 96 * 2)
    with _Eager(model):
        want2 = infer(images[0], conf_thre=thr2)
    assert not _equal(want2, want[0][0])
    for _ in range(3):
        assert _equal(infer(images[0], conf_thre=thr2), want2)
    assert (infer.graph_captures, infer.graph_replays) == (2, 3)

    # ``torch.export`` (as ``serve/engine.py`` runs it on the card) traces
    # the eager call: no capture, no replay, and the graphs replay after.
    torch.export.export(_Program(model, infer), (
        images[1], _scalar(thr), _scalar(t["iou_thre"])))
    assert (infer.graph_captures, infer.graph_replays) == (2, 3)
    assert _equal(infer(images[1]), want[1][0])
    assert (infer.graph_captures, infer.graph_replays) == (2, 4)

    # Under a profiler: the eager call, with its spans.
    metrics.reset_spans()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            out, n = _call(infer, images[3])
        (spans,) = metrics.spans_by_call().values()
    finally:
        metrics.reset_spans()
    assert (infer.graph_captures, infer.graph_replays) == (2, 4)
    assert _equal(out, want[3][0]) and n == launches
    names = [sp.name for sp in spans]
    assert {"infer", "conv", "decode", "nms"} <= set(names)
    assert "sync" not in names


def test_card_calls_of_many_shapes_stop_graphing(card):
    """Native-size calls (``Detector.detect``): each of ``GRAPH_KEYS``
    sizes seen twice is captured; the next size drops the graphs, and every
    later call is eager and equal to the eager call."""
    model = get_model("YOLOv2", dtype=BF16, device=card, image_size=(416, 416),
                      seed=1)
    infer = make_infer_fn(model, 0.0, 0.5, 16, compact=True)
    sizes = [(64 + 32 * i, 96) for i in range(GRAPH_KEYS + 1)]
    images = [_images(1, hw, seed=30 + i, device=card)
              for i, hw in enumerate(sizes)]
    with _Eager(model):
        want = [infer(x) for x in images]
    for x, w in zip(images[:-1], want):
        for _ in range(3):
            assert _equal(infer(x), w)
    assert infer.graphing
    assert (infer.graph_captures, infer.graph_replays) == (GRAPH_KEYS,
                                                           GRAPH_KEYS)
    assert _equal(infer(images[-1]), want[-1])
    assert not infer.graphing
    for x, w in zip(images + images, want + want):
        assert _equal(infer(x), w)
    assert (infer.graph_captures, infer.graph_replays) == (GRAPH_KEYS,
                                                           GRAPH_KEYS)


def test_card_a_sharded_model_is_never_graphed(card):
    """A conv sharded over a model axis (``parallel/mesh.py::shard_model``
    marks it ``model_shard``) gathers in its forward: the function stays
    eager."""
    model = get_model("YOLOv2", dtype=BF16, device=card, image_size=HW, seed=1)
    assert make_infer_fn(model, 0.5, 0.5, 16).graphing
    conv = next(m for m in model.modules() if isinstance(m, torch.nn.Conv2d))
    conv.model_shard = object()
    assert not make_infer_fn(model, 0.5, 0.5, 16).graphing
