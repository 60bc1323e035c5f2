"""The conv blocks' fused inference epilogue
(``odc_tpu_torch/ops/cuda/bias_bn_leaky_kernel.py``, ``csrc/bias_bn_leaky.cu``)
and its route in ``models/layers.py::ConvBnLeaky``.

On the CPU: the plain version against the unfused passes the card runs, the
wrapper's checks, the route's predicate, ``torch.export`` of a block on the
fused route, and the ``fused_epilogue`` counter with the benchmark's metric
that reads it.  On a card (skipped without one; run there with
``python -m pytest --noconftest tests/test_torch_bias_bn_leaky.py -k card``):
the kernel against the unfused route at every block of YOLOv2-416 and
YOLOv3-416, ``make_infer_fn``'s outputs, and the launches a call.  This file
imports no JAX."""

import importlib.util
import types
from unittest import mock

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import profile

from benchmark import harness
from odc_tpu_torch.models.layers import ConvBnLeaky, TorchBatchNorm
from odc_tpu_torch.ops.cuda.bias_bn_leaky_kernel import (
    bias_bn_leaky, bias_bn_leaky_plain,
)
from odc_tpu_torch.utils import metrics

BF16 = torch.bfloat16
OP = torch.ops.odc_tpu_torch.bias_bn_leaky.default


def _randomize_bn(module, gen):
    """Running statistics and affine parameters away from identity."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, TorchBatchNorm):
                n = m.running_mean.numel()
                m.running_mean.copy_(torch.randn(n, generator=gen) * 0.2)
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))
                m.weight.copy_(0.75 + 0.5 * torch.rand(n, generator=gen))
                m.bias.copy_(torch.rand(n, generator=gen) - 0.5)


def _block(cin, c, k=3, seed=0, **kw):
    gen = torch.Generator().manual_seed(seed)
    block = ConvBnLeaky(cin, c, k, dtype=BF16, generator=gen, **kw)
    _randomize_bn(block, gen)
    return block.eval()


def _args(block):
    bn = block.bn
    return (block.conv.bias, bn.running_mean, bn.running_var, bn.weight,
            bn.bias, bn.eps, block.negative_slope)


def _conv_without_bias(block, x):
    """The block's bf16 conv output without its bias, NHWC."""
    h = x.to(BF16)
    if block.pad_input:
        (t, b), (l, r) = block.pads(*h.shape[1:3])
        h = F.pad(h, (0, 0, l, r, t, b))
    return block._conv_nhwc(h, block.conv.weight.to(BF16), None).contiguous()


def _unfused(block, y):
    """What the card runs without the kernel: ATen's bf16 bias add after the
    conv, then the block's BN, leaky and the cast."""
    t = y + block.conv.bias.to(BF16)
    return F.leaky_relu(block.bn(t), block.negative_slope).to(BF16)


@pytest.mark.parametrize("c, shape", [(32, (2, 5, 7)), (64, (3, 3, 9)),
                                      (1024, (1, 3, 5))])
def test_plain_equals_the_unfused_passes(c, shape):
    """Bitwise, on bf16 conv outputs of odd spatial sizes; the operator's
    CPU path is the plain version."""
    block = _block(16, c, seed=c)
    x = torch.randn(*shape, 16, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        y = _conv_without_bias(block, x)
        want = _unfused(block, y)
        got = bias_bn_leaky_plain(y, *_args(block))
        via_op = bias_bn_leaky(y, *_args(block))
    assert got.dtype == BF16 and got.shape == y.shape
    assert torch.equal(got, want)
    assert torch.equal(via_op, want)
    assert bool((got < 0).any()) and bool((got > 0).any())


def _bad_inputs(case):
    c = 16
    x = torch.randn(2, 3, c).to(BF16)
    vecs = [torch.randn(c) for _ in range(5)]
    if case == "channels":
        x = torch.randn(2, 3, 12).to(BF16)
        vecs = [torch.randn(12) for _ in range(5)]
    elif case == "dtype":
        x = x.float()
    elif case == "device":
        x = x.to("meta")
        vecs = [v.to("meta") for v in vecs]
    elif case == "alignment":
        x = torch.zeros(1 + x.numel(), dtype=BF16)[1:].view(2, 3, c)
    elif case == "strides":
        x = torch.randn(2, c, 3).to(BF16).transpose(1, 2)
    elif case == "vector_shape":
        vecs[1] = torch.randn(c + 8)
    elif case == "vector_dtype":
        vecs[3] = vecs[3].to(BF16)
    return x, vecs


@pytest.mark.parametrize("case, err", [
    ("channels", ValueError), ("dtype", TypeError), ("device", ValueError),
    ("alignment", ValueError), ("strides", ValueError),
    ("vector_shape", ValueError), ("vector_dtype", ValueError)])
def test_wrapper_rejects(case, err):
    x, vecs = _bad_inputs(case)
    with pytest.raises(err):
        bias_bn_leaky(x, *vecs, 1e-5, 0.1)


def _fake_cuda_input(cin):
    """What the predicate reads of a CUDA input: its device and its
    channels."""
    return types.SimpleNamespace(is_cuda=True, shape=(2, 8, 8, cin))


@pytest.mark.parametrize("case", ["fused", "cpu", "training", "f32",
                                  "sharded", "int8"])
def test_route_predicate(case):
    """Only an eval-mode bf16 block on a CUDA input with an unsharded,
    non-int8 conv takes the fused route."""
    cin = 128
    block = _block(cin, 32, int8_dynamic=case == "int8")
    x = _fake_cuda_input(cin)
    if case == "cpu":
        x = torch.zeros(2, 8, 8, cin)
    elif case == "training":
        block.train()
    elif case == "f32":
        block.dtype = torch.float32
    elif case == "sharded":
        block.conv.model_shard = object()
    assert block._fuses_epilogue(x) == (case == "fused")


def test_cpu_forward_keeps_the_unfused_passes():
    """On the CPU the block runs the conv with its bias and the separate BN,
    leaky and cast, as before the kernel existed."""
    block = _block(8, 32)
    x = torch.randn(2, 5, 7, 8, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        w, b = block.conv.weight.to(BF16), block.conv.bias.to(BF16)
        y = block._conv_nhwc(x.to(BF16), w, b)
        want = F.leaky_relu(block.bn(y), 0.1).to(BF16)
        assert torch.equal(block(x), want)


def test_export_captures_the_operator(monkeypatch):
    """``torch.export`` of an eval block on the fused route (forced on the
    CPU) holds one ``bias_bn_leaky`` node whose fake gives the output's
    shape (symbolic in the batch) and dtype; the exported program runs the
    plain version, bitwise the unfused passes."""
    monkeypatch.setattr(ConvBnLeaky, "_fuses_epilogue", lambda self, x: True)
    block = _block(8, 32, stride=2)
    x = torch.randn(3, 9, 11, 8, generator=torch.Generator().manual_seed(3))
    batch = torch.export.Dim("batch", min=1, max=64)
    with torch.no_grad():
        ep = torch.export.export(block, (x,), dynamic_shapes=({0: batch},))
        got = ep.module()(x)
        want = _unfused(block, _conv_without_bias(block, x))
    nodes = [n for n in ep.graph.nodes if n.target is OP]
    assert len(nodes) == 1
    val = nodes[0].meta["val"]
    assert val.dtype == BF16
    assert isinstance(val.shape[0], torch.SymInt)
    assert tuple(val.shape[1:]) == (5, 6, 32)
    assert torch.equal(got, want)


# -- the counter and the benchmark's metric ----------------------------------


def _bn_span(sid, fused):
    sp = metrics.Span("bn_leaky", None, sid, 0, 0)
    sp.counts = {"fused_epilogue": 1} if fused else None
    return sp


def test_share_metric_on_hand_built_spans(monkeypatch):
    """fused_epilogue counts over bn_leaky spans a call, the median over the
    calls; silent without bn_leaky spans and for a program without the
    fused epilogue."""
    calls = {0: [_bn_span(1, True), _bn_span(2, True)],
             1: [_bn_span(1, True), _bn_span(2, False)],
             2: [_bn_span(1, False)]}
    monkeypatch.setattr(metrics, "spans_by_call", lambda: calls)
    mod = harness.load_module("metrics", "fused_epilogue_share.infer")
    assert mod.read(None) == pytest.approx(0.5)
    monkeypatch.setattr(metrics, "spans_by_call", lambda: {0: []})
    assert mod.read(None) is None
    monkeypatch.setattr(metrics, "spans_by_call", lambda: calls)
    monkeypatch.setattr(importlib.util, "find_spec", lambda name: None)
    assert mod.read(None) is None


@pytest.mark.parametrize("forced", [False, True])
def test_traced_call_counts_each_fused_block(monkeypatch, forced):
    """Under a profiler, a YOLOv2 call (64 x 64, bf16, on the CPU) counts
    ``fused_epilogue`` once in each block's ``bn_leaky`` span when the route
    engages (forced here; the card takes it by itself) and never when it
    does not."""
    from odc_tpu_torch.models.yolov2 import YOLOv2
    from odc_tpu_torch.ops.detect import make_infer_fn

    if forced:
        monkeypatch.setattr(ConvBnLeaky, "_fuses_epilogue",
                            lambda self, x: True)
    model = YOLOv2(dtype=BF16, device="cpu", image_size=(64, 64), seed=1)
    infer = make_infer_fn(model, 0.0, 0.5, 16, compact=True)
    images = torch.randint(0, 256, (1, 64, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(0))
    metrics.reset_spans()
    try:
        with torch.no_grad(), profile():
            infer(images)
        (call,) = metrics.spans_by_call().values()
        blocks = [sp for sp in call if sp.name == "bn_leaky"]
        counted = [(sp.counts or {}).get("fused_epilogue", 0) for sp in blocks]
        share = harness.load_module(
            "metrics", "fused_epilogue_share.infer").read(None)
    finally:
        metrics.reset_spans()
    assert len(blocks) > 0
    assert counted == [int(forced)] * len(blocks)
    assert share == float(forced)


# -- on the card -----------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "--noconftest tests/test_torch_bias_bn_leaky.py -k card)")
    return "cuda"


def _unfused_route():
    return mock.patch.object(ConvBnLeaky, "_fuses_epilogue",
                             lambda self, x: False)


def _card_model(name, device):
    """``name`` at 416 x 416, bf16 compute, BN statistics set from one
    forward (the unfused route, so every BN module sees its input) and
    moved off them, as ``chip_smoke.py`` calibrates."""
    from odc_tpu_torch.models.yolov2 import YOLOv2
    from odc_tpu_torch.models.yolov3 import YOLOv3

    cls = {"YOLOv2": YOLOv2, "YOLOv3": YOLOv3}[name]
    model = cls(dtype=BF16, device=device, seed=0).eval()
    gen = torch.Generator().manual_seed(5)

    def set_stats(bn, args):
        x = args[0].float().reshape(-1, args[0].shape[-1])
        n = x.shape[1]
        jitter = torch.randn(n, generator=gen).to(x.device)
        scale = (0.5 + torch.rand(n, generator=gen)).to(x.device)
        bn.running_mean.copy_(x.mean(0) + 0.2 * jitter * x.var(0).sqrt())
        bn.running_var.copy_(x.var(0) * scale)

    hooks = [m.register_forward_pre_hook(set_stats)
             for m in model.modules() if isinstance(m, TorchBatchNorm)]
    with torch.no_grad(), _unfused_route():
        model(_images(8, device))
    for h in hooks:
        h.remove()
    return model


def _images(n, device, seed=6):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, 416, 416, 3), generator=gen,
                         dtype=torch.uint8).to(device)


def _block_outputs(model, images):
    """Every ConvBnLeaky's output of one forward, in call order."""
    seen = []
    hooks = [m.register_forward_hook(lambda m, a, out: seen.append(out))
             for m in model.modules() if isinstance(m, ConvBnLeaky)]
    try:
        with torch.no_grad():
            head = model(images)
    finally:
        for h in hooks:
            h.remove()
    return seen, head


@pytest.mark.parametrize("name", ["YOLOv2", "YOLOv3"])
def test_card_kernel_equals_unfused_route_at_every_block(card, name):
    """Batch 2 at 416 x 416: every block's output and the head (YOLOv3's
    three) are bitwise the unfused route's."""
    model = _card_model(name, card)
    images = _images(2, card)
    fused, head = _block_outputs(model, images)
    with _unfused_route():
        plain, head_plain = _block_outputs(model, images)
    assert len(fused) == len(plain) > 0
    for i, (a, b) in enumerate(zip(fused, plain)):
        assert bool(torch.isfinite(a).all()), i
        assert torch.equal(a, b), (i, tuple(a.shape))
    heads = (head, head_plain) if torch.is_tensor(head) else (
        torch.cat([h.flatten() for h in head]),
        torch.cat([h.flatten() for h in head_plain]))
    assert torch.equal(*heads)


@pytest.mark.parametrize("name, blocks", [("YOLOv2", 19), ("YOLOv3", 70)])
def test_card_infer_fn_bitwise_and_launches(card, name, blocks):
    """A ``make_infer_fn`` call launches the kernel once a block (YOLOv2:
    stages 3-7 and the neck, the fused stem doing stages 1-2) and returns
    outputs bitwise those of the unfused route."""
    from odc_tpu_torch.ops.detect import make_infer_fn

    model = _card_model(name, card)
    infer = make_infer_fn(model, 0.05, 0.5, 64)
    images = _images(2, card, seed=7)
    before = bias_bn_leaky.launches
    out = infer(images)
    torch.cuda.synchronize()
    assert bias_bn_leaky.launches - before == blocks
    with _unfused_route():
        out_plain = infer(images)
    assert bias_bn_leaky.launches - before == blocks
    for a, b in zip(out, out_plain):
        assert torch.equal(a, b)
    assert bool(out[-1].any())
