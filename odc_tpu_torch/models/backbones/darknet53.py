"""Darknet-53 backbone, NHWC at the boundaries.

Port of ``odc_tpu/models/backbones/darknet53.py``: a 3x3 stem, then five
stride-2 3x3 downsampling convs, each followed by N residual bottlenecks
(1x1 reduce -> 3x3 expand, additive skip) with N = 1, 2, 8, 8, 4.  Returns
the taps c3 [N, H/8, W/8, 256], c4 [N, H/16, W/16, 512] and c5
[N, H/32, W/32, 1024] a YOLOv3 FPN reads.

``downsample_padding`` is ``"VALID"`` by default, the JAX package's parity
default with the reference (``floor((s - 3) / 2) + 1``: the taps do not
halve exactly); YOLOv3 passes ``"SAME"`` (XLA's rule, ``(0, 1)`` on an even
size).  ``int8_dynamic`` reaches every 3x3 conv (``ConvBnLeaky`` applies it
only to those with at least 128 input channels, in eval mode).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from odc_tpu_torch.models.layers import (
    ConvBnLeaky, Residual, imagenet_normalize,
)

# The prefix probes ``forward(stop_after=...)`` takes: the stem, then each
# downsample + residual block.
PROBES = ("stem", "b1", "b2", "b3", "b4", "b5")

# (downsample features, residual repeats) per stage.
_BLOCKS = (
    (64, 1),
    (128, 2),
    (256, 8),
    (512, 8),
    (1024, 4),
)


class Darknet53Backbone(nn.Module):
    def __init__(
        self,
        dtype: torch.dtype = torch.float32,
        downsample_padding: str = "VALID",
        int8_dynamic: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, generator=generator)
        self.stem = ConvBnLeaky(3, 32, 3, **kw)
        stages = []
        cin = 32
        for features, repeat in _BLOCKS:
            stages.append(nn.Sequential(
                ConvBnLeaky(cin, features, 3, stride=2,
                            padding=downsample_padding,
                            int8_dynamic=int8_dynamic, **kw),
                *(Residual(features, features // 2,
                           int8_dynamic=int8_dynamic, **kw)
                  for _ in range(repeat)),
            ))
            cin = features
        self.stages = nn.ModuleList(stages)

    def forward(
        self, x: torch.Tensor, stop_after: Optional[str] = None
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """[N, H, W, 3] RGB (0-255) -> (c3, c4, c5), NHWC.

        ``stop_after`` (a prefix-timing probe, inference only): ``"stem"``
        or ``"b1"``..``"b5"`` returns the map after that block, as the JAX
        package's ``Darknet53Backbone(stop_after=...)``; the differences of
        adjacent prefixes' times are the blocks' costs."""
        check_probe(self, stop_after, PROBES)
        h = self.stem(imagenet_normalize(x, self.dtype))
        if stop_after == "stem":
            return h
        taps = []
        for i, stage in enumerate(self.stages):
            h = stage(h)
            taps.append(h)
            if stop_after == f"b{i + 1}":
                return h
        return taps[2], taps[3], taps[4]


def check_probe(model: nn.Module, stop_after: Optional[str],
                probes: Tuple[str, ...]) -> None:
    """Raise unless ``stop_after`` is None or one of ``probes`` of an
    eval-mode ``model``."""
    if stop_after is None:
        return
    if stop_after not in probes:
        raise ValueError(f"stop_after must be one of {probes}, got "
                         f"{stop_after!r}")
    if model.training:
        raise ValueError("stop_after is an inference-only probe (call "
                         ".eval() first)")
