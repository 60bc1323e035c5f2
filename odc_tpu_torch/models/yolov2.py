"""YOLOv2 network: Darknet-19 -> quadrant-stack neck -> 3x3 conv -> 1x1 head.

Port of ``odc_tpu/models/yolov2.py``: c5 [N, H/16, W/16, 512] is stacked
into its TL/TR/BL/BR quadrants on channels (the reference's neck, not the
paper's space-to-depth, which stays available as ``neck="space_to_depth"``),
concatenated with c7 to 3072 channels, then Conv3x3(3072->1024)+BN+leaky and
a Conv1x1 head reshaped to [N, Hg, Wg, A, 5 + C] in NHWC order.

``forward(valid_hw=...)`` is the masked native-size forward over a batch
padded to a common bucket: each image's valid grid cells equal its
native-size run (the JAX package's evaluation semantics).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from odc_tpu_torch import resolve_device
from odc_tpu_torch.models.backbones.darknet19 import Darknet19Backbone
from odc_tpu_torch.models.layers import ConvBnLeaky, _conv_init_, extent_mask
from odc_tpu_torch.ops.decode import YOLOV2_ANCHORS, Detections, decode_v2


def quadrant_stack(h1: torch.Tensor) -> torch.Tensor:
    """[N, H, W, C] -> [N, H//2, W//2, 4C], channel blocks TL/TR/BL/BR.
    Odd trailing rows/cols are dropped."""
    _, hh, ww, _ = h1.shape
    h, w = hh // 2, ww // 2
    hw = torch.cat([h1[:, :, :w], h1[:, :, w : 2 * w]], dim=-1)
    return torch.cat([hw[:, :h], hw[:, h : 2 * h]], dim=-1)


def quadrant_stack_dynamic(
    h1: torch.Tensor, e16h: torch.Tensor, e16w: torch.Tensor
) -> torch.Tensor:
    """Per-image quadrant reorg of a PADDED batch: [N, H, W, C] ->
    [N, H//2, W//2, 4C], each image split at ITS native half extents
    (``e16h // 2``, ``e16w // 2``, [N] integer tensors) rather than the
    bucket's.  Offsets are gather indices on the tensors' device (no host
    sync); like ``jax.lax.dynamic_slice`` each start is clamped to
    ``[0, H - H//2]``.  Values beyond each image's quadrant extent are junk
    that the caller masks."""
    b, hh, ww, _ = h1.shape
    h, w = hh // 2, ww // 2
    qh = (e16h // 2).clamp(0, hh - h)[:, None, None]  # [N, 1, 1]
    qw = (e16w // 2).clamp(0, ww - w)[:, None, None]
    rows = torch.arange(h, device=h1.device)[None, :, None]  # [1, h, 1]
    cols = torch.arange(w, device=h1.device)[None, None, :]  # [1, 1, w]
    img = torch.arange(b, device=h1.device)[:, None, None]
    return torch.cat([
        h1[:, :h, :w], h1[img, rows, qw + cols], h1[img, qh + rows, cols],
        h1[img, qh + rows, qw + cols],
    ], dim=-1)


def space_to_depth(h1: torch.Tensor) -> torch.Tensor:
    """Paper-style stride-2 reorg: [N, 2h, 2w, C] -> [N, h, w, 4C]."""
    n, hh, ww, c = h1.shape
    h, w = hh // 2, ww // 2
    h1 = h1[:, : 2 * h, : 2 * w].reshape(n, h, 2, w, 2, c)
    return h1.permute(0, 1, 3, 2, 4, 5).reshape(n, h, w, 4 * c)


class YOLOv2(nn.Module):
    """YOLOv2, for inference (``.eval()``: running BN statistics, optional
    fused stem) and for training (``.train()``: batch BN statistics, the
    unfused stem).  Parameters are float32, drawn from a ``torch.Generator``
    seeded with ``seed`` (PyTorch's default Conv2d init, BN at identity),
    built on the CPU and moved to ``device``; convolutions run in ``dtype``.
    ``device`` defaults to ``"cuda"`` and raises if no card is present.

    ``remat``: recompute the Darknet-19 stages' activations in the backward
    pass (training only; see ``Darknet19Backbone``), as the JAX package's
    ``YOLOv2(remat=True)``: less memory for a longer step, the same
    parameters, outputs and gradients."""

    mode = "v2"  # target assignment, loss and detect contract
    # The ``ModelConfig`` fields the constructor takes (``train.py``'s).
    config_fields = ("image_size",)

    def __init__(
        self,
        num_cls: int = 20,
        anchors: Sequence[Tuple[float, float]] = YOLOV2_ANCHORS,
        neck: str = "quadrant",
        dtype: torch.dtype = torch.float32,
        image_size: Tuple[int, int] = (416, 416),
        device="cuda",
        seed: int = 0,
        remat: bool = False,
    ):
        super().__init__()
        if neck not in ("quadrant", "space_to_depth"):
            raise ValueError(f"unknown neck {neck!r}")
        dev = resolve_device(device)
        self.num_cls = num_cls
        self.anchors = tuple(tuple(a) for a in anchors)
        self.neck_kind = neck
        self.dtype = dtype
        self.image_size = tuple(image_size)
        gen = torch.Generator().manual_seed(seed)
        self.backbone = Darknet19Backbone(dtype=dtype, generator=gen,
                                          remat=remat)
        self.neck = ConvBnLeaky(3072, 1024, 3, dtype=dtype, generator=gen)
        self.head = nn.Conv2d(1024, self.num_anchor_box * (5 + num_cls), 1)
        _conv_init_(self.head, gen)
        self.to(dev)

    @property
    def num_anchor_box(self) -> int:
        return len(self.anchors)

    def forward(
        self,
        x: torch.Tensor,
        stem_out: Optional[torch.Tensor] = None,
        neck_override: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        valid_hw=None,
    ) -> torch.Tensor:
        """[N, H, W, 3] RGB (0-255) -> raw head [N, Hg, Wg, A, 5 + C] f32
        (f64 for a float64 model).

        ``stem_out`` (inference only): the fused stem's [N, H/4, W/4, 64]
        map in place of stages 1-2 (see ``ops/detect.py``).
        ``neck_override`` (inference only, ignored in training mode): a
        replacement of the 3x3 neck conv, such as the quantized
        ``ops/quantize.py::int8_conv_bn_leaky``, applied to the
        [N, Hg, Wg, 3072] concat.

        ``valid_hw`` ([N, 2] native sizes, a tensor or array; inference
        only, without ``stem_out`` or ``neck_override``): the masked forward
        of a batch padded top-left to a common bucket.  Cells
        ``[:h // 32, :w // 32]`` of each image's output equal its
        native-size run; the cells beyond are junk the caller masks (see
        ``ops/detect.py::make_native_infer_fn``)."""
        if valid_hw is None:
            c5, c7 = self.backbone(x, stem_out=stem_out)
            reorg = (quadrant_stack if self.neck_kind == "quadrant"
                     else space_to_depth)
            h = torch.cat([reorg(c5), c7], dim=-1)  # [N, Hg, Wg, 3072]
        else:
            if self.training or neck_override is not None:
                raise ValueError("valid_hw is an inference-only path "
                                 "(no train/neck_override)")
            valid_hw = torch.as_tensor(valid_hw, device=x.device).long()
            c5, c7 = self.backbone(x, stem_out=stem_out, valid_hw=valid_hw)
            e16h, e16w = valid_hw[:, 0] // 16, valid_hw[:, 1] // 16
            if self.neck_kind == "quadrant":
                p = quadrant_stack_dynamic(c5, e16h, e16w)
            else:
                # space_to_depth is block-local (translation-invariant under
                # top-left-aligned padding): the static reorg is exact.
                p = space_to_depth(c5)
            h = torch.cat([p, c7], dim=-1)
            # Mask before the 3x3 neck conv: valid grid = (h//32, w//32).
            h = h * extent_mask(h.shape, e16h // 2, e16w // 2).to(h.dtype)
        if neck_override is not None and not self.training:
            h = neck_override(h)
        else:
            h = self.neck(h)  # [N, Hg, Wg, 1024]
        dt = self.dtype
        y = F.conv2d(
            h.permute(0, 3, 1, 2), self.head.weight.to(dt), self.head.bias.to(dt)
        ).permute(0, 2, 3, 1)  # NHWC before the reshape
        n, hg, wg, _ = y.shape
        return y.reshape(n, hg, wg, self.num_anchor_box, 5 + self.num_cls).to(
            torch.promote_types(dt, torch.float32))

    def decode(self, y: torch.Tensor, image_hw=None) -> Detections:
        return decode_v2(y, tuple(image_hw or self.image_size), self.anchors)
