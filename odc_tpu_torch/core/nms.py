"""Fixed-shape greedy NMS, batched over images.

Port of ``odc_tpu/core/nms.py``.  A confidence filter and a stable
descending sort pick the top ``max_keep`` candidates of each image (static
shape); the greedy suppression over them is one launch of the CUDA kernel
for the whole batch on the card (``ops/cuda/nms_kernel.py``), or its plain
version on the CPU.  The JAX package ``vmap``s one image at a time.

Tie order: ``lax.top_k`` and the stable ``argsort(-score)`` of the JAX
package keep index order among equal scores, including the ``-inf`` of
invalid boxes.  ``torch.topk`` promises no tie order, so both branches here
use ``torch.sort(..., descending=True, stable=True)`` and slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from odc_tpu_torch.ops.cuda.nms_kernel import suppress


def _gather_rows(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """x [B, N, D], order [B, k] -> [B, k, D]."""
    return x.gather(1, order[..., None].expand(-1, -1, x.shape[-1]))


def sorted_candidates(
    boxes: torch.Tensor, score: torch.Tensor, valid: torch.Tensor,
    max_keep: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top ``min(max_keep, N)`` candidates of each image by score, valid
    first: (order [B, k], boxes [B, k, 4], survivors [B, k] bool)."""
    n = boxes.shape[1]
    k = min(max_keep, n)
    score = torch.where(valid, score, float("-inf"))
    top_score, order = torch.sort(score, dim=-1, descending=True, stable=True)
    order = order[:, :k]
    if k < n:
        survivors = top_score[:, :k] > float("-inf")
    else:
        survivors = valid.gather(1, order)
    return order, _gather_rows(boxes, order).contiguous(), survivors.contiguous()


def _suppress(
    boxes: torch.Tensor, score: torch.Tensor, valid: torch.Tensor,
    iou_thre: float, max_keep: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched fixed-shape suppression: boxes [B, N, 4], score/valid [B, N]
    -> (order [B, k], keep [B, k]) over the sorted candidates."""
    order, cand, survivors = sorted_candidates(boxes, score, valid, max_keep)
    return order, suppress(cand, survivors, iou_thre)


def nms_padded(
    boxes: torch.Tensor,
    conf: torch.Tensor,
    cls_scores: torch.Tensor,
    conf_thre: float = 0.9,
    iou_thre: float = 0.5,
    max_keep: int = 128,
    suppress_boxes: Optional[torch.Tensor] = None,
):
    """Greedy NMS with static output shapes, batched over a leading image dim.

    Args:
        boxes: [B, ..., 4] corner-format boxes (per-image dims flattened).
        conf: [B, ...] confidences; ``conf < conf_thre`` drops a box.
        cls_scores: [B, ..., C] class-specific scores.
        conf_thre, iou_thre: runtime thresholds, floats or 0-d float32
            CPU tensors (an exported program's inputs: a CPU scalar enters
            elementwise ops on the card as a scalar, and the NMS operator
            reads ``iou_thre`` on the host, so neither waits on the card).
        max_keep: the static candidate budget per image.
        suppress_boxes: optional [B, ..., 4] boxes for the overlap test in
            place of ``boxes`` (class-wise NMS passes class-offset boxes).

    Returns:
        (boxes [B, max_keep, 4], conf [B, max_keep], cls_scores
        [B, max_keep, C], keep [B, max_keep] bool), sorted by descending
        confidence; entries with ``keep == False`` are zero.
    """
    b = boxes.shape[0]
    num_cls = cls_scores.shape[-1]
    boxes = boxes.reshape(b, -1, 4)
    conf = conf.reshape(b, -1)
    cls_scores = cls_scores.reshape(b, -1, num_cls)
    sup = boxes if suppress_boxes is None else suppress_boxes.reshape(b, -1, 4)

    valid = conf >= conf_thre
    order, keep = _suppress(sup, conf, valid, iou_thre, max_keep)

    out_boxes = _gather_rows(boxes, order)
    out_conf = conf.gather(1, order)
    out_cls = _gather_rows(cls_scores, order)

    pad = max_keep - order.shape[1]
    if pad:  # pad up to the static budget
        out_boxes = F.pad(out_boxes, (0, 0, 0, pad))
        out_conf = F.pad(out_conf, (0, pad))
        out_cls = F.pad(out_cls, (0, 0, 0, pad))
        keep = F.pad(keep, (0, pad))

    return (
        torch.where(keep[..., None], out_boxes, 0.0),
        torch.where(keep, out_conf, 0.0),
        torch.where(keep[..., None], out_cls, 0.0),
        keep,
    )


def class_offset_boxes(
    boxes: torch.Tensor, cls_idx: torch.Tensor, offset: float = 1e5
) -> torch.Tensor:
    """Translate boxes per class so class-wise NMS reduces to class-agnostic."""
    return boxes + cls_idx.to(boxes.dtype)[..., None] * offset


def nms(
    boxes: torch.Tensor,
    conf: torch.Tensor,
    cls_scores: torch.Tensor,
    conf_thre: float = 0.9,
    iou_thre: float = 0.5,
    max_keep: int = 128,
    class_wise: bool = False,
):
    """One image: runs the fixed-shape suppression, then compacts.

    Returns ``(boxes [M, 4], conf [M], cls_scores [M, C])`` sorted by
    descending confidence, on the inputs' device."""
    num_cls = cls_scores.shape[-1]
    boxes = boxes.reshape(1, -1, 4)
    conf = conf.reshape(1, -1)
    cls_scores = cls_scores.reshape(1, -1, num_cls)
    nms_boxes = (
        class_offset_boxes(boxes, cls_scores.argmax(-1)) if class_wise else boxes
    )
    order, keep = _suppress(nms_boxes, conf, conf >= conf_thre, iou_thre, max_keep)
    idx = order[0][keep[0]]
    return boxes[0, idx], conf[0, idx], cls_scores[0, idx]
