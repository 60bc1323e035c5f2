"""YOLOv4 network: CSPDarknet53 -> SPP -> PANet -> three heads.

From ``cfg/yolov4.cfg`` of AlexeyAB/darknet (Bochkovskiy, Wang & Liao,
"YOLOv4: Optimal Speed and Accuracy of Object Detection",
arXiv:2004.10934), at its published 608 x 608 input.  CBL is conv + BN +
leaky 0.1 (``ConvBnLeaky``), CBM conv + BN + Mish; every conv pads
``k // 2`` on every side (``"SYMMETRIC"``).

- Backbone: :class:`CSPDarknet53Backbone`, 72 CBM blocks, taps C3/C4/C5.
- SPP: CBL 1x1 512, 3x3 1024, 1x1 512; ``concat[maxpool13, maxpool9,
  maxpool5, x]`` (stride 1, ``-inf`` padding ``k // 2``; 2048 channels);
  CBL 1x1 512, 3x3 1024, 1x1 512 -> P5.
- Top-down: ``concat[CBL(C4, 1x1 -> 256), up2(CBL(P5, 1x1 -> 256))]``, five
  CBL (1x1 256, 3x3 512, 1x1 256, 3x3 512, 1x1 256) -> P4; the same with
  C3, P4 and 128/256 -> P3.
- Bottom-up and heads: ``y8 = conv1x1(CBL(P3, 3x3 -> 256))``; ``N4`` = five
  CBL over ``concat[CBL(P3, 3x3 s2 -> 256), P4]`` at 256/512, ``y16 =
  conv1x1(CBL(N4, 3x3 -> 512))``; ``N5`` = five CBL over
  ``concat[CBL(N4, 3x3 s2 -> 512), P5]`` at 512/1024, ``y32 =
  conv1x1(CBL(N5, 3x3 -> 1024))``.  The head convs are linear with a bias,
  ``3 * (5 + C)`` wide.

110 convolutions: 72 CBM, 35 CBL, 3 linear.  Heads come out coarsest first,
as ``decode_v3`` reads them, with YOLOv4's grid sensitivity ``scale_x_y``
(1.05, 1.1, 1.2 at strides 32, 16, 8).

Departures from the published network: the conv blocks keep a conv bias
before BN, as every ``ConvBnLeaky`` does (Darknet has none; BN's shift
absorbs it); BN's eps is 1e-5 inside the square root; Mish is ``F.mish``
(Darknet's softplus switches to ``x`` above 20); VOC's 20 classes, so the
heads are 75 wide (COCO's are 255); the heads come out coarsest first.
Inference only: no CIoU loss, no mosaic, no int8.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from odc_tpu_torch import resolve_device
from odc_tpu_torch.models.backbones.cspdarknet53 import CSPDarknet53Backbone
from odc_tpu_torch.models.layers import (
    ConvBnLeaky, _conv_init_, max_pool_same,
)
from odc_tpu_torch.models.yolov3 import conv1x1, upsample2
from odc_tpu_torch.ops.decode import Detections, decode_v3
from odc_tpu_torch.utils.metrics import span

# yolov4.cfg's anchors, (width, height) in pixels, smallest first; groups
# of 3 attach to the stride-8, 16 and 32 heads.
YOLOV4_ANCHORS: Tuple[Tuple[float, float], ...] = (
    (12.0, 16.0), (19.0, 36.0), (40.0, 28.0),        # stride 8
    (36.0, 75.0), (76.0, 55.0), (72.0, 146.0),       # stride 16
    (142.0, 110.0), (192.0, 243.0), (459.0, 401.0),  # stride 32
)

# yolov4.cfg's scale_x_y per head, coarsest (stride 32) first.
YOLOV4_SCALE_X_Y: Tuple[float, float, float] = (1.05, 1.1, 1.2)


def cbl(cin: int, cout: int, k: int, stride: int = 1, **kw) -> ConvBnLeaky:
    """conv + BN + leaky 0.1, Darknet's symmetric padding."""
    return ConvBnLeaky(cin, cout, k, stride=stride, padding="SYMMETRIC", **kw)


def five(cin: int, f: int, **kw) -> nn.Sequential:
    """1x1 f, 3x3 2f, 1x1 f, 3x3 2f, 1x1 f (CBL)."""
    plan = ((1, f), (3, 2 * f), (1, f), (3, 2 * f), (1, f))
    layers = []
    for k, out in plan:
        layers.append(cbl(cin, out, k, **kw))
        cin = out
    return nn.Sequential(*layers)


class SPP(nn.Module):
    """Three CBL, the spatial pyramid pool, three CBL (P5)."""

    def __init__(self, **kw):
        super().__init__()
        self.pre = nn.Sequential(cbl(1024, 512, 1, **kw),
                                 cbl(512, 1024, 3, **kw),
                                 cbl(1024, 512, 1, **kw))
        self.post = nn.Sequential(cbl(2048, 512, 1, **kw),
                                  cbl(512, 1024, 3, **kw),
                                  cbl(1024, 512, 1, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.pre(x)
        with span("spp"):
            x = torch.cat([max_pool_same(x, 13), max_pool_same(x, 9),
                           max_pool_same(x, 5), x], dim=-1)
        return self.post(x)


class YOLOv4(nn.Module):
    """YOLOv4 for inference (``.eval()``: running BN statistics).
    Parameters are float32, drawn from a ``torch.Generator`` seeded with
    ``seed`` (PyTorch's default Conv2d init, BN at identity), built on the
    CPU and moved to ``device``; convolutions run in ``dtype``.  ``device``
    defaults to ``"cuda"`` and raises if no card is present.  Inputs are
    [N, H, W, 3] RGB uint8 with H and W multiples of 32."""

    mode = "v3"  # the detect contract: three heads, decode_v3
    # The ``ModelConfig`` fields the constructor takes.
    config_fields = ("image_size",)

    def __init__(
        self,
        num_cls: int = 20,
        anchors: Sequence[Tuple[float, float]] = YOLOV4_ANCHORS,
        dtype: torch.dtype = torch.float32,
        image_size: Tuple[int, int] = (608, 608),
        device="cuda",
        seed: int = 0,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.num_cls = num_cls
        self.anchors = tuple(tuple(a) for a in anchors)
        if len(self.anchors) != 9:
            raise ValueError(f"YOLOv4 takes 9 (w, h) anchors, got "
                             f"{len(self.anchors)}")
        self.scale_x_y = YOLOV4_SCALE_X_Y
        self.dtype = dtype
        self.image_size = tuple(image_size)
        gen = torch.Generator().manual_seed(seed)
        kw = dict(dtype=dtype, generator=gen)
        out_dim = self.num_anchor_box * (5 + num_cls)
        self.backbone = CSPDarknet53Backbone(**kw)
        self.spp = SPP(**kw)
        # Top-down.
        self.reduce16 = cbl(512, 256, 1, **kw)
        self.lateral16 = cbl(512, 256, 1, **kw)
        self.five16 = five(512, 256, **kw)
        self.reduce8 = cbl(256, 128, 1, **kw)
        self.lateral8 = cbl(256, 128, 1, **kw)
        self.five8 = five(256, 128, **kw)
        # Bottom-up and heads.
        self.head8 = cbl(128, 256, 3, **kw)
        self.out8 = nn.Conv2d(256, out_dim, 1)
        self.down16 = cbl(128, 256, 3, stride=2, **kw)
        self.bottom16 = five(512, 256, **kw)
        self.head16 = cbl(256, 512, 3, **kw)
        self.out16 = nn.Conv2d(512, out_dim, 1)
        self.down32 = cbl(256, 512, 3, stride=2, **kw)
        self.bottom32 = five(1024, 512, **kw)
        self.head32 = cbl(512, 1024, 3, **kw)
        self.out32 = nn.Conv2d(1024, out_dim, 1)
        for conv in (self.out8, self.out16, self.out32):
            _conv_init_(conv, gen)
        self.to(dev)

    @property
    def num_anchor_box(self) -> int:
        return 3  # per scale; 9 anchors over the three heads

    def _head(self, h, conv3, out):
        y = conv1x1(conv3(h), out, self.dtype)
        n, hg, wg, _ = y.shape
        return y.reshape(n, hg, wg, self.num_anchor_box,
                         5 + self.num_cls).float()

    def forward(self, x: torch.Tensor):
        """[N, H, W, 3] RGB (0-255) -> (y32, y16, y8), each
        [N, H / s, W / s, 3, 5 + C] float32, coarsest first."""
        c3, c4, c5 = self.backbone(x)
        p5 = self.spp(c5)
        p4 = self.five16(torch.cat(
            [self.lateral16(c4), upsample2(self.reduce16(p5))], dim=-1))
        p3 = self.five8(torch.cat(
            [self.lateral8(c3), upsample2(self.reduce8(p4))], dim=-1))
        y8 = self._head(p3, self.head8, self.out8)
        n4 = self.bottom16(torch.cat([self.down16(p3), p4], dim=-1))
        y16 = self._head(n4, self.head16, self.out16)
        n5 = self.bottom32(torch.cat([self.down32(n4), p5], dim=-1))
        y32 = self._head(n5, self.head32, self.out32)
        return y32, y16, y8

    def decode(self, ys, image_hw=None) -> Detections:
        return decode_v3(ys, tuple(image_hw or self.image_size), self.anchors,
                         scale_x_y=self.scale_x_y)
