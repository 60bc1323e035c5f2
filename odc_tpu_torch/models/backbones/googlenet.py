"""GoogLeNet (Inception v1) backbone, NHWC at the boundaries.

Port of ``odc_tpu/models/backbones/googlenet.py``: the in-model ImageNet
normalize, a 7x7/2 stem conv, two 3x3/2 ceil-mode pools around a 1x1 and a
3x3 conv, then inceptions 3a-3b, 4a-4e and 5a-5b with ceil-mode pools
between the groups.  224x224 RGB gives [N, 7, 7, 1024].

torchvision semantics, as the JAX package reproduces them:

* ``BasicConv2d`` = conv without bias + BatchNorm(eps=1e-3) + ReLU, then a
  cast to the compute dtype;
* convs pad ``(k - 1) // 2`` on both sides, torch-style: the 7x7/2 stem
  pads (3, 3), not SAME's (2, 3);
* the "5x5" inception branch is a 3x3 conv (torchvision's quirk, kept for
  weight compatibility).

Module names are torchvision's (``conv1``, ``inception3a.branch2.0``, ...,
``branch4.0`` being the parameterless pool), so a torchvision
``state_dict`` loads one to one (``convert_googlenet.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from odc_tpu_torch.models.layers import (
    TorchBatchNorm, _conv_init_, imagenet_normalize, max_pool_3x3_ceil,
    max_pool_same,
)

# (ch1x1, ch3x3red, ch3x3, ch5x5red, ch5x5, pool_proj) per inception block.
_INCEPTIONS = {
    "3a": (64, 96, 128, 16, 32, 32),
    "3b": (128, 128, 192, 32, 96, 64),
    "4a": (192, 96, 208, 16, 48, 64),
    "4b": (160, 112, 224, 24, 64, 64),
    "4c": (128, 128, 256, 24, 64, 64),
    "4d": (112, 144, 288, 32, 64, 64),
    "4e": (256, 160, 320, 32, 128, 128),
    "5a": (256, 160, 320, 32, 128, 128),
    "5b": (384, 192, 384, 48, 128, 128),
}
# The BasicConv2d units of one inception block, in the JAX package's
# construction order (its BasicConv2d_0..5).
INCEPTION_UNITS = (
    "branch1", "branch2.0", "branch2.1", "branch3.0", "branch3.1", "branch4.1",
)


class BasicConv2d(nn.Module):
    """Conv (no bias) + BatchNorm(eps=1e-3) + ReLU, NHWC in and out.  The
    conv runs in ``dtype``; BN and ReLU in float32, then the cast."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel: int = 1,
        stride: int = 1,
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(
            in_features, features, kernel, stride=stride,
            padding=(kernel - 1) // 2, bias=False,
        )
        if generator is not None:
            _conv_init_(self.conv, generator)
        self.bn = TorchBatchNorm(features, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = F.conv2d(
            x.to(dt).permute(0, 3, 1, 2), self.conv.weight.to(dt),
            stride=self.conv.stride, padding=self.conv.padding,
        ).permute(0, 2, 3, 1)
        return F.relu(self.bn(y)).to(dt)


class _Pool3x3Same(nn.Module):
    """Inception branch 4's 3x3/1 SAME max pool as a module, so the branch's
    conv keeps torchvision's name ``branch4.1``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool_same(x, 3)


class Inception(nn.Module):
    def __init__(
        self,
        in_features: int,
        ch1x1: int,
        ch3x3red: int,
        ch3x3: int,
        ch5x5red: int,
        ch5x5: int,
        pool_proj: int,
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()

        def unit(cin, cout, k):
            return BasicConv2d(cin, cout, k, dtype=dtype, generator=generator)

        self.branch1 = unit(in_features, ch1x1, 1)
        self.branch2 = nn.Sequential(
            unit(in_features, ch3x3red, 1), unit(ch3x3red, ch3x3, 3))
        # torchvision's quirk: the "5x5" branch is a 3x3 conv.
        self.branch3 = nn.Sequential(
            unit(in_features, ch5x5red, 1), unit(ch5x5red, ch5x5, 3))
        self.branch4 = nn.Sequential(
            _Pool3x3Same(), unit(in_features, pool_proj, 1))
        self.features = ch1x1 + ch3x3 + ch5x5 + pool_proj

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat(
            [self.branch1(x), self.branch2(x), self.branch3(x),
             self.branch4(x)],
            dim=-1,
        )


class GoogLeNetBackbone(nn.Module):
    """[N, H, W, 3] RGB (0-255) -> [N, ceil(H/2) // 16, ceil(W/2) // 16,
    1024] in ``dtype`` (224x224 -> 7x7).  Parameters are float32, drawn
    from ``generator`` when one is given (PyTorch's default Conv2d init,
    BN at identity)."""

    def __init__(
        self,
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, generator=generator)
        self.conv1 = BasicConv2d(3, 64, 7, stride=2, **kw)
        self.conv2 = BasicConv2d(64, 64, 1, **kw)
        self.conv3 = BasicConv2d(64, 192, 3, **kw)
        cin = 192
        for name, widths in _INCEPTIONS.items():
            block = Inception(cin, *widths, **kw)
            setattr(self, f"inception{name}", block)
            cin = block.features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # The reference's in-model ImageNet normalize; torchvision's
        # transform_input is bypassed there too.
        h = imagenet_normalize(x, self.dtype)
        h = max_pool_3x3_ceil(self.conv1(h))
        h = max_pool_3x3_ceil(self.conv3(self.conv2(h)))
        h = self.inception3b(self.inception3a(h))
        h = max_pool_3x3_ceil(h)
        for name in ("4a", "4b", "4c", "4d", "4e"):
            h = getattr(self, f"inception{name}")(h)
        h = max_pool_3x3_ceil(h)
        return self.inception5b(self.inception5a(h))
