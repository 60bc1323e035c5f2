"""CSPDarknet53, YOLOv4's backbone, NHWC at the boundaries.

From ``cfg/yolov4.cfg`` of AlexeyAB/darknet (Bochkovskiy, Wang & Liao,
arXiv:2004.10934): a 3x3 stem, then five cross-stage-partial stages.  Every
conv is a CBM block (conv + BN + Mish, ``ConvBnLeaky(activation="mish")``)
padded ``k // 2`` on every side at every stride (``"SYMMETRIC"``).  Stage
``i`` with ``c`` output channels and ``n`` residual blocks:

1. ``d`` = CBM(3x3, stride 2, -> c);
2. two 1x1 branches of ``d``: ``a`` = CBM(-> c/2) and ``b`` = CBM(-> c/2);
3. ``n`` residual blocks on ``b``: ``b + CBM(CBM(b, 1x1 -> c/2), 3x3 -> c/2)``;
4. the transition ``b`` = CBM(b, 1x1 -> c/2);
5. the output CBM(concat[b, a], 1x1 -> c).

Stage 1 is the exception: its branches and transition are 64 wide (not 32),
its residual 1x1 is 32 wide, its fuse 128 -> 64.  Returns the taps c3
[N, H/8, W/8, 256], c4 [N, H/16, W/16, 512] and c5 [N, H/32, W/32, 1024].
The input is ``x / 255`` (the published preprocessing, no ImageNet
normalize).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from odc_tpu_torch.models.layers import ConvBnLeaky, Residual

# (output channels, residual blocks) per stage.
STAGES = ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4))


def cbm(cin: int, cout: int, k: int, stride: int = 1, **kw) -> ConvBnLeaky:
    """conv + BN + Mish, Darknet's symmetric padding."""
    return ConvBnLeaky(cin, cout, k, stride=stride, padding="SYMMETRIC",
                       activation="mish", **kw)


class CSPStage(nn.Module):
    """One cross-stage-partial stage (see the module docstring)."""

    def __init__(self, cin: int, c: int, repeat: int, first: bool, **kw):
        super().__init__()
        branch = c if first else c // 2
        mid = c // 2
        self.down = cbm(cin, c, 3, stride=2, **kw)
        self.part_a = cbm(c, branch, 1, **kw)
        self.part_b = cbm(c, branch, 1, **kw)
        self.blocks = nn.Sequential(
            *(Residual(branch, mid, padding="SYMMETRIC",
                       activation="mish", **kw)
              for _ in range(repeat)))
        self.transition = cbm(branch, branch, 1, **kw)
        self.fuse = cbm(2 * branch, c, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.down(x)
        a = self.part_a(d)
        b = self.transition(self.blocks(self.part_b(d)))
        return self.fuse(torch.cat([b, a], dim=-1))


class CSPDarknet53Backbone(nn.Module):
    def __init__(self, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, generator=generator)
        self.stem = cbm(3, 32, 3, **kw)
        stages, cin = [], 32
        for i, (c, repeat) in enumerate(STAGES):
            stages.append(CSPStage(cin, c, repeat, first=i == 0, **kw))
            cin = c
        self.stages = nn.ModuleList(stages)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """[N, H, W, 3] RGB (0-255, any dtype) -> (c3, c4, c5), NHWC."""
        h = self.stem(x.to(torch.float32) / 255.0)
        taps = []
        for stage in self.stages:
            h = stage(h)
            taps.append(h)
        return taps[2], taps[3], taps[4]
