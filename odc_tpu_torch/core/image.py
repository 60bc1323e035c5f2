"""ImageNet input normalization, shared by the models and the superstem
kernel's plain version (which must not import the models: a loaded serving
artifact needs the kernels and nothing of ``models/``)."""

from __future__ import annotations

import torch

from odc_tpu_torch.utils.metrics import span

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def imagenet_normalize(
    x: torch.Tensor, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """uint8/float RGB [N, H, W, 3] -> normalized, staying NHWC."""
    with span("sync", site="imagenet_normalize.mean"):
        mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32,
                            device=x.device)
    with span("sync", site="imagenet_normalize.std"):
        std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    x = (x.float() / 255.0 - mean) / std
    return x.to(dtype)
