"""The five-part masked-mean YOLO loss, computed on compact targets.

Port of ``odc_tpu/losses/yolo_loss.py``.  Every term of the reference loss
lives at a box's own (cell, responsible-anchor) coordinate, so each reduces
to a gather plus a masked mean over boxes:

* responsible anchor = argmax over anchors of IoU(pred boxes at the box's
  cell, gt box), the IoU detached;
* ``loss_xy``   — mean over 2·M elements of (sig(txty)_tgt − sig(txty)_pred)²;
* ``loss_wh``   — the same in sqrt space: v1 ``sqrt(sig(twth))``, v2
  ``sqrt(bwbh / anchor)`` against ``sqrt(exp(twth))``;
* ``loss_conf`` — (IoU − conf)² at the responsible slot, mean over M (the
  confidence target is the IoU);
* ``loss_noobj``— mean of conf² over every not-responsible slot of every
  per-box map: ``Σ_b (Σ_grid conf²(i(b)) − conf²_resp(b))`` over a count of
  ``M·(Hg·Wg·A − 1)``;
* ``loss_cls``  — Σ_C (onehot − cls_prob)², v1 masked by the obj cell, v2 by
  the responsible anchor; mean over M.

All means divide by the true selected-element count with a ``max(count, 1)``
guard, so an empty batch yields 0 instead of NaN.  The validity masks
multiply, they do not select: padded rows must hold finite values (their
``sqrt(twth / anchor)`` is 0).  Total = Σ λᵢ·partᵢ.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from odc_tpu_torch.core.boxes import iou
from odc_tpu_torch.ops.assign import YoloTargets
from odc_tpu_torch.ops.decode import Detections


class Lambdas(NamedTuple):
    """Loss weights; names mirror the TRAIN_CONFIG keys."""

    lambda_xy: float = 5.0
    lambda_wh: float = 5.0
    lambda_conf: float = 1.0
    lambda_noobj: float = 0.5
    lambda_cls: float = 1.0


class LossParts(NamedTuple):
    xy: torch.Tensor
    wh: torch.Tensor
    conf: torch.Tensor
    noobj: torch.Tensor
    cls: torch.Tensor


def _cell_index(targets: YoloTargets):
    """Index tensors (batch [B, 1], cy [B, M], cx [B, M]) that gather a
    ``[B, Hg, Wg, ...]`` prediction at every box's cell -> ``[B, M, ...]``."""
    b = targets.cell.shape[0]
    batch_idx = torch.arange(b, device=targets.cell.device)[:, None]
    return batch_idx, targets.cell[..., 0].long(), targets.cell[..., 1].long()


def _take_resp(x: torch.Tensor, resp: torch.Tensor) -> torch.Tensor:
    """[B, M, A, ...] -> [B, M, ...] at the responsible anchor [B, M]."""
    idx = resp.view(resp.shape + (1,) * (x.dim() - 2))
    idx = idx.expand(x.shape[:2] + (1,) + x.shape[3:])
    return torch.gather(x, 2, idx).squeeze(2)


def _safe_mean(x, mask, denom):
    return torch.sum(x * mask) / torch.clamp(denom, min=1.0)


def _per_box_terms(
    det: Detections,
    targets: YoloTargets,
    mode: str,
    anchors,
):
    """Per-box squared-error terms shared by the batched and per-image
    reductions: (sq_xy, sq_wh, sq_conf, noobj_sum, sq_cls, valid,
    grid_slots), each term [B, M]."""
    _, hg, wg, a = det.conf.shape
    grid_slots = hg * wg * a
    at = _cell_index(targets)

    # Per-box gathers at the target cell: [B, M, A, ...].
    sig_txty_p = det.sig_txty[at]
    twth_p = det.twth[at]
    boxes_p = det.boxes[at]
    conf_p = det.conf[at]

    # Responsible anchor: argmax IoU(pred, gt) at the cell, IoU detached.
    iou_cell = iou(boxes_p, targets.box[:, :, None, :]).detach()  # [B, M, A]
    resp = torch.argmax(iou_cell, dim=-1)  # [B, M]

    sig_txty_r = _take_resp(sig_txty_p, resp)  # [B, M, 2]
    twth_r = _take_resp(twth_p, resp)          # [B, M, 2]
    conf_r = _take_resp(conf_p, resp)          # [B, M]
    iou_r = _take_resp(iou_cell, resp)         # [B, M]

    sq_xy = torch.sum((targets.sig_txty - sig_txty_r) ** 2, dim=-1)

    # wh (sqrt space).
    if mode == "v1":
        wh_tgt = torch.sqrt(targets.twth)  # sqrt(sig-space wh)
        wh_pred = torch.sqrt(twth_r)       # pred already sig(twth)
    else:
        if anchors is None:
            raise ValueError("anchors required for mode='v2'")
        pwph = torch.tensor(anchors, dtype=torch.float32, device=resp.device)
        wh_tgt = torch.sqrt(targets.twth / pwph[resp])
        wh_pred = torch.sqrt(twth_r)       # pred already exp(twth)
    sq_wh = torch.sum((wh_tgt - wh_pred) ** 2, dim=-1)

    # conf (target = IoU).
    sq_conf = (iou_r - conf_r) ** 2

    # noobj: for box b in image i the per-box map holds image i's full conf
    # grid minus b's one responsible slot.
    conf_sq_sum = torch.sum(det.conf**2, dim=(1, 2, 3))  # [B]
    noobj_sum = conf_sq_sum[:, None] - conf_r**2  # [B, M]

    # cls.
    num_cls = det.cls_prob.shape[-1]
    onehot = F.one_hot(targets.cls.long(), num_cls).float()
    cls_p = det.cls_prob[at]
    if mode != "v1":  # [B, M, A, C] -> the responsible anchor's [B, M, C]
        cls_p = _take_resp(cls_p, resp)
    sq_cls = torch.sum((onehot - cls_p) ** 2, dim=-1)

    valid = targets.valid.float()  # [B, M]
    return sq_xy, sq_wh, sq_conf, noobj_sum, sq_cls, valid, grid_slots


def yolo_loss(
    det: Detections,
    targets: YoloTargets,
    lambdas: Lambdas = Lambdas(),
    mode: str = "v2",
    anchors: Optional[Tuple[Tuple[float, float], ...]] = None,
    count_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, LossParts]:
    """The λ-weighted five-part loss over the batch.

    Args:
        det: decoded predictions for the image batch.
        targets: compact padded targets from :mod:`odc_tpu_torch.ops.assign`.
        lambdas: loss weights.
        mode: "v1" or "v2" (wh space and cls masking differ, see above).
        anchors: required for mode="v2" — (w, h) priors in grid units.
        count_sum: data parallelism: the sum over ranks of a count
            (``parallel.DataParallel.sum_counts``).  The box count is then
            the global batch's, and the loss this rank's share of the
            global batch's loss (the ranks' losses sum to it).
    """
    sq_xy, sq_wh, sq_conf, noobj_sum, sq_cls, valid, grid_slots = (
        _per_box_terms(det, targets, mode, anchors)
    )
    num_boxes = torch.sum(valid)
    if count_sum is not None:
        num_boxes = count_sum(num_boxes)

    parts = LossParts(
        _safe_mean(sq_xy, valid, 2.0 * num_boxes),
        _safe_mean(sq_wh, valid, 2.0 * num_boxes),
        _safe_mean(sq_conf, valid, num_boxes),
        _safe_mean(noobj_sum, valid, num_boxes * (grid_slots - 1)),
        _safe_mean(sq_cls, valid, num_boxes),
    )
    total = (
        lambdas.lambda_xy * parts.xy
        + lambdas.lambda_wh * parts.wh
        + lambdas.lambda_conf * parts.conf
        + lambdas.lambda_noobj * parts.noobj
        + lambdas.lambda_cls * parts.cls
    )
    return total, parts


def yolo_loss_per_image(
    det: Detections,
    targets: YoloTargets,
    lambdas: Lambdas = Lambdas(),
    mode: str = "v2",
    anchors: Optional[Tuple[Tuple[float, float], ...]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-image losses — the reference's validation semantics, batched.

    The reference validates at batch size 1, so its epoch loss is the mean
    over per-image losses where every masked mean divides by that image's
    own box count.  Returns ``(losses [B], has_box [B] bool)``; images with
    no valid box (padded tail rows) get loss 0 and ``has_box`` False."""
    sq_xy, sq_wh, sq_conf, noobj_sum, sq_cls, valid, grid_slots = (
        _per_box_terms(det, targets, mode, anchors)
    )
    m_i = torch.sum(valid, dim=1)  # [B]
    denom = torch.clamp(m_i, min=1.0)

    def mean_i(x, scale=1.0):
        return torch.sum(x * valid, dim=1) / (denom * scale)

    loss_i = (
        lambdas.lambda_xy * mean_i(sq_xy, 2.0)
        + lambdas.lambda_wh * mean_i(sq_wh, 2.0)
        + lambdas.lambda_conf * mean_i(sq_conf)
        + lambdas.lambda_noobj * mean_i(noobj_sum, float(grid_slots - 1))
        + lambdas.lambda_cls * mean_i(sq_cls)
    )
    has_box = m_i > 0
    return torch.where(has_box, loss_i, torch.zeros_like(loss_i)), has_box


def yolo_loss_paper(
    det: Detections,
    targets: YoloTargets,
    lambda_coord: float = 5.0,
    lambda_noobj: float = 0.5,
) -> Tuple[torch.Tensor, LossParts]:
    """Paper-style per-box-sum loss: per-box grid sums instead of masked
    means, confidence target 1 (not the IoU), noobj target 0, class term
    masked by the obj cell (a v1 head: ``cls_prob`` [B, Hg, Wg, C]),
    ``lambda_coord`` on xy + wh, final mean over boxes."""
    at = _cell_index(targets)
    iou_cell = iou(det.boxes[at], targets.box[:, :, None, :]).detach()
    resp = torch.argmax(iou_cell, dim=-1)

    valid = targets.valid.float()
    num_boxes = torch.clamp(torch.sum(valid), min=1.0)

    xy_b = torch.sum(
        (targets.sig_txty - _take_resp(det.sig_txty[at], resp)) ** 2, -1
    )
    wh_b = torch.sum(
        (torch.sqrt(targets.twth)
         - torch.sqrt(_take_resp(det.twth[at], resp))) ** 2,
        -1,
    )
    conf_r = _take_resp(det.conf[at], resp)
    conf_b = (1.0 - conf_r) ** 2
    conf_sq = torch.sum(det.conf**2, dim=(1, 2, 3))  # [B]
    noobj_b = conf_sq[:, None] - conf_r**2
    num_cls = det.cls_prob.shape[-1]
    onehot = F.one_hot(targets.cls.long(), num_cls).float()
    cls_b = torch.sum((onehot - det.cls_prob[at]) ** 2, -1)

    per_box = (
        lambda_coord * (xy_b + wh_b) + conf_b + lambda_noobj * noobj_b + cls_b
    )
    total = torch.sum(per_box * valid) / num_boxes
    parts = LossParts(
        torch.sum(xy_b * valid) / num_boxes,
        torch.sum(wh_b * valid) / num_boxes,
        torch.sum(conf_b * valid) / num_boxes,
        torch.sum(noobj_b * valid) / num_boxes,
        torch.sum(cls_b * valid) / num_boxes,
    )
    return total, parts
