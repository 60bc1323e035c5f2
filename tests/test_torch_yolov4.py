"""YOLOv4 (``models/yolov4.py``, ``models/backbones/cspdarknet53.py``), the
conv block's Mish activation and symmetric padding
(``models/layers.py::ConvBnLeaky``), ``decode_v3``'s ``scale_x_y`` and the
Mish epilogue (``ops/cuda/bias_bn_mish_kernel.py``, ``csrc/bias_bn_mish.cu``).

On the CPU, float32 at 64 x 64, batch 2: the heads against the plain
reference (``tests/plain_yolov4.py``) on the same seeded weights, the
decode, ``make_infer_fn`` at a gap threshold, the plain epilogue against the
unfused passes, the padding, the spans and the refusals.  On a card
(skipped without one; ``python -m pytest --noconftest
tests/test_torch_yolov4.py -k card``): the kernel against its plain version
at the cell's shapes, and every block of a YOLOv4 call against the unfused
route.  This file imports no JAX."""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import profile

import plain_yolov4 as plain
from odc_tpu_torch.config import ModelConfig
from odc_tpu_torch.models import MODEL_REGISTRY, get_model, model_from_config
from odc_tpu_torch.models.layers import ConvBnLeaky, TorchBatchNorm
from odc_tpu_torch.models.yolov4 import YOLOV4_ANCHORS, YOLOv4
from odc_tpu_torch.ops import decode as tdecode
from odc_tpu_torch.ops.cuda.bias_bn_mish_kernel import (
    bias_bn_mish, bias_bn_mish_plain,
)
from odc_tpu_torch.ops.detect import make_infer_fn, make_native_infer_fn
from odc_tpu_torch.utils import metrics

BF16 = torch.bfloat16
HW = (64, 64)
OP = torch.ops.odc_tpu_torch.bias_bn_mish.default


def _images(n, hw=HW, seed=6):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, *hw, 3), generator=gen, dtype=torch.uint8)


def _calibrate(model, images, seed=5):
    """Every BN's running statistics from one forward (the unfused route)
    and moved off them, and BN's scale and shift away from identity: the
    random network keeps O(1) activations to the heads."""
    gen = torch.Generator().manual_seed(seed)

    def set_stats(bn, args):
        x = args[0].float().reshape(-1, args[0].shape[-1])
        n = x.shape[1]
        jitter = torch.randn(n, generator=gen).to(x.device)
        scale = (0.5 + torch.rand(n, generator=gen)).to(x.device)
        bn.running_mean.copy_(x.mean(0) + 0.2 * jitter * x.var(0).sqrt())
        bn.running_var.copy_(x.var(0) * scale)
        bn.weight.copy_(0.75 + 0.5 * torch.rand(n, generator=gen).to(x.device))
        bn.bias.copy_(0.5 + torch.rand(n, generator=gen).to(x.device))

    hooks = [m.register_forward_pre_hook(set_stats)
             for m in model.modules() if isinstance(m, TorchBatchNorm)]
    with torch.no_grad(), mock.patch.object(
            ConvBnLeaky, "_fuses_epilogue", lambda self, x: False):
        model(images)
    for h in hooks:
        h.remove()
    return model


@pytest.fixture(scope="module")
def f32_model():
    model = YOLOv4(device="cpu", image_size=HW, seed=3).eval()
    return _calibrate(model, _images(4, seed=1))


def test_architecture():
    """110 convolutions: 72 Mish blocks (the backbone), 35 leaky blocks
    (SPP, PANet, heads) and 3 linear heads; every block pads k // 2."""
    model = YOLOv4(device="meta")
    blocks = [m for m in model.modules() if isinstance(m, ConvBnLeaky)]
    convs = [m for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    assert len(convs) == 110 and len(blocks) == 107
    assert sum(b.activation == "mish" for b in blocks) == 72
    assert all(b.activation == "mish" for b in model.backbone.modules()
               if isinstance(b, ConvBnLeaky))
    assert {b.padding for b in blocks} == {"SYMMETRIC"}
    assert sum(p.numel() for p in model.parameters()) == 64073153
    assert model.image_size == (608, 608) and model.mode == "v3"
    assert model.anchors == YOLOV4_ANCHORS and model.scale_x_y == (1.05, 1.1, 1.2)


def test_heads_match_the_plain_reference(f32_model):
    """The three heads, f32, within the v3 parity tolerance (summation
    order)."""
    x = _images(2, seed=9)
    with torch.no_grad():
        got = f32_model(x)
    want = plain.PlainYOLOv4(f32_model.state_dict())(x)
    assert [tuple(g.shape) for g in got] == [(2, 2, 2, 3, 25), (2, 4, 4, 3, 25),
                                             (2, 8, 8, 3, 25)]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert float(w.std()) > 0.3  # calibrated: not bias-dominated
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-3, atol=2e-3)


def _heads(seed=4, hw=HW):
    g = torch.Generator().manual_seed(seed)
    return tuple(3 * torch.randn(2, hw[0] // s, hw[1] // s, 3, 25, generator=g)
                 for s in (32, 16, 8))


def test_decode_scale_x_y_matches_the_plain_decode():
    heads = _heads()
    det = tdecode.decode_v3(heads, HW, YOLOV4_ANCHORS, scale_x_y=(1.05, 1.1, 1.2))
    boxes, conf, scores = plain.decode(heads, HW, YOLOV4_ANCHORS)
    np.testing.assert_allclose(det.boxes.numpy(), boxes.numpy(), rtol=0, atol=1e-4)
    assert torch.equal(det.conf, conf) and torch.equal(det.cls_spec, scores)


def test_decode_without_scale_x_y_is_yolov3s():
    """``scale_x_y=None`` runs YOLOv3's centres op for op: bitwise."""
    heads = _heads(seed=5)
    det = tdecode.decode_v3(heads, HW, YOLOV4_ANCHORS)
    want = []
    for s, y in enumerate(heads):
        hg, wg = y.shape[1:3]
        grp = torch.tensor(YOLOV4_ANCHORS[6 - 3 * s:9 - 3 * s], dtype=y.dtype)
        cy = torch.arange(hg, dtype=y.dtype).view(1, hg, 1, 1)
        cx = torch.arange(wg, dtype=y.dtype).view(1, 1, wg, 1)
        sig = torch.sigmoid(y[..., 0:2])
        ex = torch.exp(y[..., 2:4])
        bx = (sig[..., 0] + cx) * (HW[1] / wg)
        by = (sig[..., 1] + cy) * (HW[0] / hg)
        bw, bh = grp[:, 0] * ex[..., 0], grp[:, 1] * ex[..., 1]
        want.append(torch.stack([bx - bw / 2, by - bh / 2, bx + bw / 2,
                                 by + bh / 2], -1).reshape(2, -1, 4))
    assert torch.equal(det.boxes, torch.cat(want, 1))


def test_infer_fn_matches_the_plain_reference(f32_model):
    """``make_infer_fn`` at a gap threshold: the same boxes kept with the
    same labels, boxes within 1e-4 of the largest coordinate."""
    x = _images(2, seed=11)
    heads = plain.PlainYOLOv4(f32_model.state_dict())(x)
    boxes, conf, scores = plain.decode(heads, HW, YOLOV4_ANCHORS)
    s = np.sort(conf.numpy().ravel().astype(np.float64))[::-1]
    r = 8 + int(np.argmax(s[8:64] - s[9:65]))
    thr = float((s[r] + s[r + 1]) / 2)
    want_boxes, want_labels, want_keep = plain.nms(boxes, conf, scores, thr, 0.5, 64)
    out = make_infer_fn(f32_model, thr, 0.5, 64, compact=True)(x)
    got_boxes, _, got_labels, _, got_keep = out
    assert torch.equal(got_keep, want_keep) and bool(got_keep.any())
    assert torch.equal(got_labels[got_keep], want_labels[want_keep].int())
    scale = float(want_boxes[want_keep].abs().max())
    assert float((got_boxes[got_keep] - want_boxes[want_keep]).abs().max()) <= 1e-4 * scale


# -- the conv block ----------------------------------------------------------


def _block(cin, c, k=3, seed=0, **kw):
    gen = torch.Generator().manual_seed(seed)
    block = ConvBnLeaky(cin, c, k, dtype=BF16, generator=gen, **kw)
    with torch.no_grad():
        bn = block.bn
        bn.running_mean.copy_(torch.randn(c, generator=gen) * 0.2)
        bn.running_var.copy_(0.5 + torch.rand(c, generator=gen))
        bn.weight.copy_(0.75 + 0.5 * torch.rand(c, generator=gen))
        bn.bias.copy_(torch.rand(c, generator=gen) - 0.5)
    return block.eval()


def _unfused(block, y):
    """What the card runs without the kernel: ATen's bf16 bias add after
    the conv, then the block's BN, Mish and the cast."""
    t = y + block.conv.bias.to(BF16)
    return F.mish(block.bn(t)).to(BF16)


def _args(block):
    bn = block.bn
    return (block.conv.bias, bn.running_mean, bn.running_var, bn.weight,
            bn.bias, bn.eps)


@pytest.mark.parametrize("c, shape", [(32, (2, 5, 7)), (64, (3, 3, 9)),
                                      (1024, (1, 3, 5))])
def test_plain_mish_epilogue_equals_the_unfused_route(c, shape):
    """Bitwise in bf16: the plain version and the operator's CPU path
    against ``ConvBnLeaky(activation="mish")``'s unfused passes."""
    block = _block(16, c, seed=c, activation="mish", padding="SYMMETRIC")
    x = torch.randn(*shape, 16, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        w = block.conv.weight.to(BF16)
        y = block._conv_nhwc(x.to(BF16), w, None).contiguous()
        want = _unfused(block, y)
        got = bias_bn_mish_plain(y, *_args(block))
        via_op = bias_bn_mish(y, *_args(block))
    assert got.dtype == BF16 and got.shape == y.shape
    assert torch.equal(got, want) and torch.equal(via_op, want)
    assert bool((got < 0).any()) and bool((got > 0).any())


@pytest.mark.parametrize("case, err", [
    ("channels", ValueError), ("dtype", TypeError), ("alignment", ValueError),
    ("strides", ValueError), ("vector_dtype", ValueError)])
def test_mish_wrapper_rejects(case, err):
    c = 16
    x = torch.randn(2, 3, c).to(BF16)
    vecs = [torch.randn(c) for _ in range(5)]
    if case == "channels":
        x, vecs = torch.randn(2, 3, 12).to(BF16), [torch.randn(12) for _ in range(5)]
    elif case == "dtype":
        x = x.float()
    elif case == "alignment":
        x = torch.zeros(1 + x.numel(), dtype=BF16)[1:].view(2, 3, c)
    elif case == "strides":
        x = torch.randn(2, c, 3).to(BF16).transpose(1, 2)
    elif case == "vector_dtype":
        vecs[3] = vecs[3].to(BF16)
    with pytest.raises(err):
        bias_bn_mish(x, *vecs, 1e-5)


def test_block_arguments_are_checked():
    with pytest.raises(ValueError, match="activation"):
        ConvBnLeaky(8, 8, activation="relu")
    with pytest.raises(ValueError, match="SYMMETRIC"):
        ConvBnLeaky(8, 8, padding="FULL")


@pytest.mark.parametrize("k, stride, hw", [(3, 2, (9, 8)), (3, 1, (5, 7)),
                                           (1, 2, (8, 8)), (3, 2, (64, 64))])
def test_symmetric_padding(k, stride, hw):
    """k // 2 on every side at every stride, as ``F.conv2d(padding=k // 2)``,
    inside the conv (no padded copy)."""
    block = ConvBnLeaky(8, 16, k, stride=stride, padding="SYMMETRIC").eval()
    assert not block.pad_input and block.conv.padding == (k // 2, k // 2)
    p = k // 2
    assert block.pads(*hw) == ((p, p), (p, p))
    x = torch.randn(2, *hw, 8, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = block(x)
        y = F.conv2d(x.permute(0, 3, 1, 2), block.conv.weight, block.conv.bias,
                     stride=stride, padding=p).permute(0, 2, 3, 1)
        want = F.leaky_relu(block.bn(y), 0.1)
    out_hw = tuple((n + 2 * p - k) // stride + 1 for n in hw)
    assert got.shape == (2, *out_hw, 16)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_export_captures_the_mish_operator(monkeypatch):
    """``torch.export`` of a Mish block on the fused route (forced on the
    CPU) holds one ``bias_bn_mish`` node; the program runs the plain
    version, bitwise the unfused passes."""
    block = _block(8, 32, activation="mish", padding="SYMMETRIC", stride=2)
    x = torch.randn(3, 9, 11, 8, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        y = block._conv_nhwc(x.to(BF16), block.conv.weight.to(BF16), None)
        want = _unfused(block, y.contiguous())
        monkeypatch.setattr(ConvBnLeaky, "_fuses_epilogue", lambda self, x: True)
        ep = torch.export.export(block, (x,))
        got = ep.module()(x)
    assert len([n for n in ep.graph.nodes if n.target is OP]) == 1
    assert torch.equal(got, want)


# -- spans, registry and refusals --------------------------------------------


@pytest.mark.parametrize("forced", [False, True])
def test_traced_call_records_the_new_spans(monkeypatch, forced):
    """Under a profiler a bf16 YOLOv4 call records 72 ``bn_mish`` and 35
    ``bn_leaky`` spans (each counting ``fused_epilogue`` once on the fused
    route, forced here), one ``spp`` span and the call's others, and no
    ``sync`` span: decode's anchors and the NMS sort's mask block on no
    copy."""
    if forced:
        monkeypatch.setattr(ConvBnLeaky, "_fuses_epilogue", lambda self, x: True)
    model = YOLOv4(dtype=BF16, device="cpu", image_size=HW, seed=1)
    infer = make_infer_fn(model, 0.0, 0.5, 16, compact=True)
    metrics.reset_spans()
    try:
        with torch.no_grad(), profile():
            infer(_images(1))
        (call,) = metrics.spans_by_call().values()
    finally:
        metrics.reset_spans()
    names = [sp.name for sp in call]
    for name, n in (("bn_mish", 72), ("bn_leaky", 35), ("conv", 107), ("spp", 1),
                    ("decode", 1), ("nms", 1), ("sync", 0), ("infer", 1)):
        assert names.count(name) == n, name
    fused = [(sp.counts or {}).get("fused_epilogue", 0) for sp in call
             if sp.name in ("bn_mish", "bn_leaky")]
    assert fused == [int(forced)] * 107


def test_registry_and_config():
    assert MODEL_REGISTRY["YOLOv4"] is YOLOv4
    cfg = ModelConfig(name="YOLOv4", num_anchor_box=3, image_size=(608, 608))
    model = model_from_config(cfg, device="meta")
    assert isinstance(model, YOLOv4) and model.image_size == (608, 608)
    small = model_from_config(dataclasses.replace(cfg, image_size=(64, 64)),
                              device="meta")
    assert small.image_size == (64, 64)
    assert isinstance(get_model("YOLOv4", device="meta"), YOLOv4)
    with pytest.raises(ValueError, match="9"):
        YOLOv4(anchors=YOLOV4_ANCHORS[:6], device="meta")


def test_int8_and_native_paths_refuse_a_yolov4():
    from odc_tpu_torch.ops.int8_engine import calibrate

    model = YOLOv4(device="cpu", image_size=HW, seed=1)
    with pytest.raises(ValueError, match="YOLOv2"):
        make_infer_fn(model, int8_scales=np.ones((22, 2), np.float32))
    with pytest.raises(ValueError, match="YOLOv2"):
        make_infer_fn(model, int8_neck=True)
    with pytest.raises(ValueError, match="YOLOv2"):
        make_native_infer_fn(model)
    with pytest.raises(ValueError, match="YOLOv2"):
        calibrate(model, _images(1))


# -- on the card -------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "--noconftest tests/test_torch_yolov4.py -k card)")
    return "cuda"


@pytest.mark.parametrize("shape", [(2, 19, 19, 1024), (2, 304, 304, 64),
                                   (3, 76, 76, 128), (1, 7, 5, 8),
                                   (64, 38, 38, 256)])
def test_card_mish_kernel_equals_plain(card, shape):
    """The kernel against its plain version (ATen's passes on the card):
    bitwise, on conv-like outputs that cover Mish's whole range."""
    c = shape[-1]
    gen = torch.Generator(device=card).manual_seed(c)
    x = (4 * torch.randn(shape, generator=gen, device=card)).to(BF16)
    vecs = [torch.randn(c, generator=gen, device=card) * 0.3,
            torch.randn(c, generator=gen, device=card) * 0.2,
            0.5 + torch.rand(c, generator=gen, device=card),
            0.75 + 0.5 * torch.rand(c, generator=gen, device=card),
            torch.rand(c, generator=gen, device=card) - 0.5]
    before = bias_bn_mish.launches
    got = bias_bn_mish(x, *vecs, 1e-5)
    want = bias_bn_mish_plain(x, *vecs, 1e-5)
    torch.cuda.synchronize()
    assert bias_bn_mish.launches - before == 1
    diff = int((got.view(torch.int16) != want.view(torch.int16)).sum())
    assert diff == 0, f"{diff} of {got.numel()} elements differ"


def test_card_mish_equals_aten_for_every_f32_input(card):
    """All 2^32 f32 inputs: the kernel's Mish after the bf16 cast is
    ``F.mish``'s."""
    from odc_tpu_torch.ops.cuda.bias_bn_mish_kernel import mish_mismatches

    assert mish_mismatches(card) == (0, 0)


def test_card_every_block_of_a_yolov4_call_equals_the_unfused_route(card):
    """Batch 2 at 608 x 608 through ``make_infer_fn``: every block's output
    and the outputs bitwise the unfused route's; 107 fused launches."""
    from odc_tpu_torch.ops.cuda.bias_bn_leaky_kernel import bias_bn_leaky

    model = _calibrate(YOLOv4(dtype=BF16, device=card, seed=0).eval(),
                       _images(8, (608, 608)).to(card))
    x = _images(2, (608, 608), seed=7).to(card)
    infer = make_infer_fn(model, 0.05, 0.5, 64, compact=True)

    def blocks():
        seen = []
        hooks = [m.register_forward_hook(lambda m, a, out: seen.append(out))
                 for m in model.modules() if isinstance(m, ConvBnLeaky)]
        try:
            out = infer(x)
        finally:
            for h in hooks:
                h.remove()
        return seen, out

    before = (bias_bn_mish.launches, bias_bn_leaky.launches)
    fused, out = blocks()
    torch.cuda.synchronize()
    assert (bias_bn_mish.launches - before[0],
            bias_bn_leaky.launches - before[1]) == (72, 35)
    with mock.patch.object(ConvBnLeaky, "_fuses_epilogue", lambda self, x: False):
        unfused, out_plain = blocks()
    assert len(fused) == len(unfused) == 107
    for i, (a, b) in enumerate(zip(fused, unfused)):
        assert torch.equal(a, b), (i, tuple(a.shape))
    for a, b in zip(out, out_plain):
        assert torch.equal(a, b)
