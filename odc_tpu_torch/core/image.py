"""ImageNet input normalization, shared by the models and the superstem
kernel's plain version (which must not import the models: a loaded serving
artifact needs the kernels and nothing of ``models/``)."""

from __future__ import annotations

import torch

from odc_tpu_torch.core.constants import device_constant

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def imagenet_normalize(
    x: torch.Tensor, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """uint8/float RGB [N, H, W, 3] -> normalized, staying NHWC."""
    mean = device_constant(IMAGENET_MEAN, torch.float32, x.device)
    std = device_constant(IMAGENET_STD, torch.float32, x.device)
    x = (x.float() / 255.0 - mean) / std
    return x.to(dtype)
