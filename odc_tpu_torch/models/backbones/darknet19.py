"""Darknet-19 backbone, NHWC at the boundaries.

Port of ``odc_tpu/models/backbones/darknet19.py``: seven stages of
Conv+BN+LeakyReLU(0.1) with 3x3/1x1 bottlenecks and 2x2/2 max pools before
stages 2..6.  Returns the two taps YOLOv2 reads: ``c5`` [N, H/16, W/16, 512]
after stage 5 and ``c7`` [N, H/32, W/32, 1024] after stage 7.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from odc_tpu_torch.models.layers import (
    ConvBnLeaky, extent_mask, imagenet_normalize, max_pool_2x2,
    rematerialize,
)

# (features, kernel) per conv within each stage; pools sit between stages.
_STAGES = (
    ((32, 3),),
    ((64, 3),),
    ((128, 3), (64, 1), (128, 3)),
    ((256, 3), (128, 1), (256, 3)),
    ((512, 3), (256, 1), (512, 3), (256, 1), (512, 3)),
    ((1024, 3), (512, 1), (1024, 3), (512, 1), (1024, 3)),
    ((1024, 3), (1024, 3)),
)


class Darknet19Backbone(nn.Module):
    """``remat``: in training with gradients on, each stage runs under
    :func:`~odc_tpu_torch.models.layers.rematerialize` (its activations
    are recomputed in the backward pass: memory traded for compute, as the
    JAX package's ``nn.remat`` stages); the parameters and their names are
    the same either way."""

    def __init__(
        self,
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
        remat: bool = False,
    ):
        super().__init__()
        self.dtype = dtype
        self.remat = remat
        stages = []
        cin = 3
        for stage in _STAGES:
            blocks = []
            for features, k in stage:
                blocks.append(
                    ConvBnLeaky(cin, features, k, dtype=dtype, generator=generator)
                )
                cin = features
            stages.append(nn.Sequential(*blocks))
        self.stages = nn.ModuleList(stages)

    def forward(
        self,
        x: torch.Tensor,
        stem_out: Optional[torch.Tensor] = None,
        valid_hw: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """[N, H, W, 3] RGB (0-255) -> (c5, c7), NHWC.

        ``stem_out`` (inference only): a precomputed
        ``pool(stage2(pool(stage1(normalize(x)))))`` map [N, H/4, W/4, 64]
        from the fused stem; stages 1-2 are then skipped.

        ``valid_hw`` ([N, 2] integer tensor, inference only): per-image
        native sizes of a batch padded (top-left aligned) to a common
        bucket.  The input of every k > 1 conv is zeroed beyond each image's
        extent (:func:`~odc_tpu_torch.models.layers.extent_mask`) and the
        extents floor-halve at each pool, so the valid region of every map
        equals the image's native-size run."""
        if stem_out is not None and valid_hw is not None:
            raise ValueError("stem_out and valid_hw are mutually exclusive")
        start = 0 if stem_out is None else 2
        h = (
            imagenet_normalize(x, self.dtype)
            if stem_out is None
            else stem_out.to(self.dtype)
        )
        eh = ew = None
        if valid_hw is not None:
            eh, ew = valid_hw[:, 0], valid_hw[:, 1]
        remat = self.remat and self.training and torch.is_grad_enabled()
        c5 = None
        for stage_idx, stage in enumerate(self.stages):
            if stage_idx < start:
                continue
            # Pool before stages 2..6; stage 3's pre-pool is inside stem_out.
            if 1 <= stage_idx <= 5 and stage_idx != start:
                h = max_pool_2x2(h)
                if eh is not None:
                    eh, ew = eh // 2, ew // 2
            if eh is None:
                h = rematerialize(stage, h) if remat else stage(h)
            else:
                # One mask a stage; 1x1 convs read no neighbourhood.
                mask = extent_mask(h.shape, eh, ew).to(h.dtype)
                for blk in stage:
                    if blk.conv.kernel_size[0] > 1:
                        h = h * mask
                    h = blk(h)
            if stage_idx == 4:
                c5 = h
        return c5, h
