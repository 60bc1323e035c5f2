"""YOLOv3 network: Darknet-53 -> top-down FPN -> three heads.

Port of ``odc_tpu/models/yolov3.py`` (the paper's architecture, Redmon &
Farhadi 2018): Darknet-53 with SAME-padded downsamples taps c3/c4/c5
(strides 8/16/32); each scale runs a five-conv block (1x1/3x3
alternating), passes a 1x1 reduction of its output up to the next finer
scale (2x nearest upsample, merged with that scale's tap), and ends in a
3x3 + 1x1 head ``[N, Hg, Wg, 3, 5 + C]``.  Heads come out coarsest first,
as ``decode_v3`` reads them.

``fused_lateral`` (the default, as in the JAX package) computes each
merge's first 1x1 conv as ``upsample2(conv_r(r)) + conv_c(c)``
(:class:`LateralMerge`), which equals ``conv1x1(concat([upsample2(r), c]))``
up to summation order and never builds the concat; ``False`` keeps the
paper's concat formulation.

``int8_dynamic`` (inference only) runs every 3x3 conv with at least 128
input channels as the dynamic int8 conv of ``layers.ConvBnLeaky``: 23 in
the backbone, 6 in the five-conv blocks and the 3 head 3x3s.  The merges
and the 1x1 reductions stay in ``dtype``, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from odc_tpu_torch import resolve_device
from odc_tpu_torch.models.backbones import darknet53
from odc_tpu_torch.models.backbones.darknet53 import Darknet53Backbone
from odc_tpu_torch.models.layers import (
    ConvBnLeaky, TorchBatchNorm, _conv_init_,
)
from odc_tpu_torch.ops.decode import YOLOV3_ANCHORS, Detections, decode_v3


# The prefix probes ``forward(stop_after=...)`` takes, in program order:
# the backbone's, then the FPN's.
PROBES = darknet53.PROBES + ("p5", "y32", "p4", "y16", "p3")


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] -> [N, 2H, 2W, C], nearest neighbour."""
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(
        n, 2 * h, 2 * w, c)


def conv1x1(x: torch.Tensor, conv: nn.Conv2d, dtype) -> torch.Tensor:
    """A 1x1 ``conv`` of an NHWC map, weights cast to ``dtype``."""
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv2d(
        x.to(dtype).permute(0, 3, 1, 2), conv.weight.to(dtype), bias
    ).permute(0, 2, 3, 1)


class FiveConv(nn.Module):
    """The per-scale block 1x1(f) 3x3(2f) 1x1(f) 3x3(2f) 1x1(f); with
    ``first=False`` the leading 1x1 is left out (a :class:`LateralMerge`
    computed it)."""

    def __init__(self, in_features: int, features: int, first: bool = True,
                 **kw):
        super().__init__()
        f = features
        plan = ((1, f), (3, 2 * f), (1, f), (3, 2 * f), (1, f))
        layers = []
        cin = in_features
        for k, out in plan if first else plan[1:]:
            layers.append(ConvBnLeaky(cin, out, k, **kw))
            cin = out
        self.layers = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x)


class LateralMerge(nn.Module):
    """The top-down merge with the five-conv block's first 1x1 fused into
    it: ``upsample2(conv_r(r)) + conv_c(c)`` (``conv_r`` with a bias,
    ``conv_c`` without), then BN, leaky and the cast to ``dtype``."""

    def __init__(self, r_features: int, c_features: int, features: int,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.conv_r = nn.Conv2d(r_features, features, 1, bias=True)
        self.conv_c = nn.Conv2d(c_features, features, 1, bias=False)
        if generator is not None:
            _conv_init_(self.conv_r, generator)
            _conv_init_(self.conv_c, generator)
        self.bn = TorchBatchNorm(features)

    def forward(self, r: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        z = upsample2(conv1x1(r, self.conv_r, dt)) + conv1x1(c, self.conv_c, dt)
        return F.leaky_relu(self.bn(z), 0.1).to(dt)


class YOLOv3(nn.Module):
    """YOLOv3, for inference (``.eval()``: running BN statistics, optional
    dynamic int8) and for training (``.train()``: batch BN statistics,
    ``int8_dynamic`` ignored).  Parameters are float32, drawn from a
    ``torch.Generator`` seeded with ``seed`` (PyTorch's default Conv2d
    init, BN at identity), built on the CPU and moved to ``device``;
    convolutions run in ``dtype``.  ``device`` defaults to ``"cuda"`` and
    raises if no card is present.  Inputs are [N, H, W, 3] RGB with H and
    W multiples of 32."""

    mode = "v3"  # target assignment, loss and detect contract
    # The ``ModelConfig`` fields the constructor takes (``train.py``'s).
    config_fields = ("image_size",)

    def __init__(
        self,
        num_cls: int = 20,
        anchors: Sequence[Tuple[float, float]] = YOLOV3_ANCHORS,
        dtype: torch.dtype = torch.float32,
        image_size: Tuple[int, int] = (416, 416),
        fused_lateral: bool = True,
        int8_dynamic: bool = False,
        device="cuda",
        seed: int = 0,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.num_cls = num_cls
        self.anchors = tuple(tuple(a) for a in anchors)
        if len(self.anchors) != 9:
            raise ValueError(f"YOLOv3 takes 9 (w, h) anchors, got "
                             f"{len(self.anchors)}")
        self.dtype = dtype
        self.image_size = tuple(image_size)
        self.fused_lateral = fused_lateral
        self.int8_dynamic = int8_dynamic
        gen = torch.Generator().manual_seed(seed)
        kw = dict(dtype=dtype, generator=gen)
        i8 = dict(int8_dynamic=int8_dynamic, **kw)
        out_dim = self.num_anchor_box * (5 + num_cls)
        self.backbone = Darknet53Backbone(
            downsample_padding="SAME", **i8)
        # Scale 32.
        self.five32 = FiveConv(1024, 512, **i8)
        self.head32 = ConvBnLeaky(512, 1024, 3, **i8)
        self.out32 = nn.Conv2d(1024, out_dim, 1)
        # Scale 16: t4 = reduce16(p5), merged with c4 (512 channels).
        self.reduce16 = ConvBnLeaky(512, 256, 1, **kw)
        if fused_lateral:
            self.merge16 = LateralMerge(256, 512, 256, **kw)
            self.five16 = FiveConv(256, 256, first=False, **i8)
        else:
            self.five16 = FiveConv(256 + 512, 256, **i8)
        self.head16 = ConvBnLeaky(256, 512, 3, **i8)
        self.out16 = nn.Conv2d(512, out_dim, 1)
        # Scale 8: t3 = reduce8(p4), merged with c3 (256 channels).
        self.reduce8 = ConvBnLeaky(256, 128, 1, **kw)
        if fused_lateral:
            self.merge8 = LateralMerge(128, 256, 128, **kw)
            self.five8 = FiveConv(128, 128, first=False, **i8)
        else:
            self.five8 = FiveConv(128 + 256, 128, **i8)
        self.head8 = ConvBnLeaky(128, 256, 3, **i8)
        self.out8 = nn.Conv2d(256, out_dim, 1)
        for conv in (self.out32, self.out16, self.out8):
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

    def _merge(self, name: str, p, tap):
        """The top-down step into the scale ``name`` ("16" or "8"):
        reduce the coarser block's output ``p``, merge it with ``tap`` and
        run the five-conv block."""
        t = getattr(self, "reduce" + name)(p)
        five = getattr(self, "five" + name)
        if self.fused_lateral:
            return five(getattr(self, "merge" + name)(t, tap))
        return five(torch.cat([upsample2(t), tap], dim=-1))

    def forward(self, x: torch.Tensor, stop_after: Optional[str] = None):
        """[N, H, W, 3] RGB (0-255) -> (y32, y16, y8), each
        [N, H / s, W / s, 3, 5 + C] float32, coarsest first.

        ``stop_after`` (a prefix-timing probe, inference only; one of
        :data:`PROBES`), as the JAX package's ``YOLOv3(stop_after=...)``:
        ``"stem"``, ``"b1"``..``"b5"`` return the backbone's map there;
        ``"p5"`` the first five-conv block's output, ``"y32"`` the first
        head; past the first head the result is CUMULATIVE, earlier heads
        included: ``"p4"`` gives ``(y32, p4)``, ``"y16"`` ``(y32, y16)``,
        ``"p3"`` ``(y32, y16, p3)``.  Each prefix then does all the work
        of the one before it (XLA would otherwise drop the heads no output
        reads), so adjacent differences of their times are the stages'
        costs in both packages."""
        darknet53.check_probe(self, stop_after, PROBES)
        if stop_after in darknet53.PROBES:
            return self.backbone(x, stop_after=stop_after)
        c3, c4, c5 = self.backbone(x)
        p5 = self.five32(c5)
        if stop_after == "p5":
            return p5
        y32 = self._head(p5, self.head32, self.out32)
        if stop_after == "y32":
            return y32
        p4 = self._merge("16", p5, c4)
        if stop_after == "p4":
            return y32, p4
        y16 = self._head(p4, self.head16, self.out16)
        if stop_after == "y16":
            return y32, y16
        p3 = self._merge("8", p4, c3)
        if stop_after == "p3":
            return y32, y16, p3
        y8 = self._head(p3, self.head8, self.out8)
        return y32, y16, y8

    def decode(self, ys, image_hw=None) -> Detections:
        return decode_v3(ys, tuple(image_hw or self.image_size), self.anchors)
