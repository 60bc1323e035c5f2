"""End-to-end batched inference: uint8 images -> NMS'd boxes, on the card.

Port of ``odc_tpu/ops/detect.py::make_infer_fn``.  One deliberate routing
difference from the JAX package's default: stages 1-2 of Darknet-19 run as
the fused superstem kernel (``ops/cuda/superstem_kernel.py``), with the BN
folded into its weights once, when the function is built.  It computes the
same function as the unfused stem within bf16 rounding.  The suppression is
one NMS kernel launch for the whole batch.

The int8 arguments follow the JAX package: ``int8_scales`` runs the full
int8 PTQ engine (``ops/int8_engine.py``) in place of the model forward and
the fused stem, 20 launches of the GEMM kernel a call; ``int8_neck`` keeps
the fused stem and swaps the 3x3 neck conv for the dynamic-PTQ int8 conv
(``ops/quantize.py``), one GEMM launch a call.
"""

from __future__ import annotations

from typing import Callable

import torch

from odc_tpu_torch.core.nms import class_offset_boxes, nms_padded
from odc_tpu_torch.ops.cuda.superstem_kernel import fold_weights, superstem
from odc_tpu_torch.ops.int8_engine import scales_tensor, yolov2_int8_forward
from odc_tpu_torch.ops.quantize import int8_conv_bn_leaky


def stem_weights(model):
    """Folded superstem weights ``(w1, w2)`` of a YOLOv2's stages 1-2, in
    the model's compute dtype, on its device."""
    blocks = [model.backbone.stages[0][0], model.backbone.stages[1][0]]
    args = []
    for blk in blocks:
        args += [
            blk.conv.weight, blk.conv.bias, blk.bn.weight, blk.bn.bias,
            blk.bn.running_mean, blk.bn.running_var,
        ]
    with torch.no_grad():
        return fold_weights(*args, eps=blocks[0].bn.eps, dtype=model.dtype)


def make_infer_fn(
    model,
    conf_thre: float = 0.9,
    iou_thre: float = 0.5,
    max_keep: int = 64,
    class_wise: bool = False,
    int8_neck: bool = False,
    int8_scales=None,
    int8_stem: str = "s2d",
    compact: bool = False,
) -> Callable:
    """Build ``infer(images, conf_thre=..., iou_thre=...)`` for a YOLOv2.

    ``images`` is [B, H, W, 3] uint8 (moved to the model's device).  Returns
    ``(boxes [B, max_keep, 4], conf [B, max_keep], cls_scores
    [B, max_keep, C], keep [B, max_keep])``, or with ``compact``
    ``(boxes, conf, labels int32, label_scores, keep)``.  The thresholds
    are runtime arguments; ``max_keep`` is fixed.  ``class_wise`` runs
    per-class suppression.  The model is put in eval mode and its stem
    weights are folded now: later weight changes need a new function.

    ``int8_scales`` (a [22, 2] range matrix from
    ``ops/int8_engine.py::calibrate``, tensor or numpy): run the full int8
    PTQ engine with the ``int8_stem`` formulation (``"s2d"``, ``"plain"``
    or ``"s2d2"``) instead of the model forward.  ``int8_neck``: the 3x3
    neck conv runs as the dynamic-PTQ int8 conv.  Both need a quadrant-neck
    YOLOv2."""
    if int8_scales is not None or int8_neck:
        # The int8 paths hardcode the Darknet-19/quadrant YOLOv2 graph; a
        # space_to_depth model would silently run the quadrant reorg and
        # produce wrong boxes.
        neck = getattr(model, "neck_kind", None)
        if type(model).__name__ != "YOLOv2" or neck != "quadrant":
            raise ValueError(
                "int8_scales/int8_neck require a YOLOv2 with neck='quadrant' "
                f"(got {type(model).__name__}, neck={neck!r})"
            )
    model.eval()
    device = next(model.parameters()).device
    if int8_scales is not None:
        int8_scales = scales_tensor(int8_scales, device)
    else:
        w1, w2 = stem_weights(model)

    def int8_neck_conv(h):
        return int8_conv_bn_leaky(h, model.neck, out_dtype=model.dtype)

    def forward(images):
        if int8_scales is not None:
            return yolov2_int8_forward(
                model, images, scales=int8_scales,
                num_anchor_box=model.num_anchor_box, num_cls=model.num_cls,
                stem=int8_stem,
            )
        return model(images, stem_out=superstem(images, w1, w2),
                     neck_override=int8_neck_conv if int8_neck else None)

    @torch.no_grad()
    def infer(images, conf_thre=conf_thre, iou_thre=iou_thre):
        images = torch.as_tensor(images, device=device)
        y = forward(images)
        det = model.decode(y, images.shape[1:3])
        b = images.shape[0]
        num_cls = det.cls_spec.shape[-1]
        boxes = det.boxes.reshape(b, -1, 4)
        conf = det.conf.reshape(b, -1)
        cls_scores = det.cls_spec.reshape(b, -1, num_cls)
        sup = (
            class_offset_boxes(boxes, cls_scores.argmax(-1))
            if class_wise
            else None
        )
        out = nms_padded(
            boxes, conf, cls_scores, conf_thre, iou_thre, max_keep,
            suppress_boxes=sup,
        )
        if not compact:
            return out
        o_boxes, o_conf, o_cls, o_keep = out
        return (
            o_boxes,
            o_conf,
            o_cls.argmax(-1).to(torch.int32),
            o_cls.max(-1).values,
            o_keep,
        )

    return infer
