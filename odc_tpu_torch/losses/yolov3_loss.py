"""The YOLOv3 multi-scale loss, with its target assignment inside.

Port of ``odc_tpu/losses/yolov3_loss.py`` (darknet yolov3.cfg conventions):

* assignment: each valid gt goes to the ONE anchor of the 9 with the
  highest width/height IoU (the first on a tie), at the cell of the gt's
  center on that anchor's scale; when two gts land on one (cell, anchor)
  slot, the first keeps it and the later ones are dropped;
* objectness: sigmoid BCE, target 1 at assigned slots and 0 elsewhere,
  except slots whose decoded box (detached) has IoU > ``ignore_iou`` with
  any gt, which are left out;
* coords: squared error of ``sigmoid(tx, ty)`` against the in-cell offset
  and of raw ``tw, th`` against ``log(gt / anchor)``, each weighted by
  ``2 - w*h / (W*H)``;
* class: per-class sigmoid BCE (multi-label, no softmax).

Only ``targets.box``/``cls``/``valid`` are read.  BCE is
``softplus(logit) - target * logit`` with the exact softplus
``logaddexp(logit, 0)`` (``jax.nn.softplus``; ``F.softplus`` switches to
the identity above its threshold).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from odc_tpu_torch.core.boxes import iou
from odc_tpu_torch.losses.yolo_loss import Lambdas, LossParts
from odc_tpu_torch.ops.assign import YoloTargets
from odc_tpu_torch.ops.decode import YOLOV3_ANCHORS, decode_v3


def _bce_logits(logit: torch.Tensor, target) -> torch.Tensor:
    """Sigmoid BCE from logits: ``logaddexp(logit, 0) - target * logit``."""
    return torch.logaddexp(logit, torch.zeros_like(logit)) - target * logit


class _ScaleTerms(NamedTuple):
    sq_xy: torch.Tensor      # [B, M] center squared error (x box scale)
    sq_wh: torch.Tensor      # [B, M] log-size squared error (x box scale)
    obj_pos: torch.Tensor    # [B, M] BCE(conf logit, 1) at the slot
    cls_bce: torch.Tensor    # [B, M] sum over classes of the BCE
    sel: torch.Tensor        # [B, M] f32: gt trains a slot of this scale
    noobj_sum: torch.Tensor  # [B] sum of BCE(conf logit, 0) over bg slots
    noobj_cnt: torch.Tensor  # [B] number of bg slots


def _per_scale_terms(y, scale_idx, num_scales, targets, image_hw, anchors,
                     anchor_list, best, ignore_iou) -> _ScaleTerms:
    b, hg, wg, a, d = y.shape
    h, w = image_hw
    num_cls = d - 5
    stride_h = h / hg
    stride_w = w / wg
    dev = y.device

    # Heads are coarsest first, anchor groups smallest first.
    grp0 = 3 * (num_scales - 1 - scale_idx)
    sel = (targets.valid & (best >= grp0) & (best < grp0 + 3)).float()
    slot = torch.clamp(best - grp0, 0, a - 1)  # [B, M]

    box = targets.box
    gw = torch.clamp(box[..., 2] - box[..., 0], min=1e-3)  # pixels
    gh = torch.clamp(box[..., 3] - box[..., 1], min=1e-3)
    gx = (box[..., 0] + box[..., 2]) / 2 / stride_w  # grid units
    gy = (box[..., 1] + box[..., 3]) / 2 / stride_h
    cx = torch.clamp(gx.to(torch.int32), 0, wg - 1)  # truncates toward 0
    cy = torch.clamp(gy.to(torch.int32), 0, hg - 1)
    tx_t = gx - cx
    ty_t = gy - cy
    aw = anchors[best][..., 0]  # [B, M] the gt's own anchor, pixels
    ah = anchors[best][..., 1]
    tw_t = torch.log(gw / aw)
    th_t = torch.log(gh / ah)
    box_scale = 2.0 - (gw * gh) / float(h * w)

    bidx = torch.arange(b, device=dev)[:, None]
    cyl, cxl, slotl = cy.long(), cx.long(), slot.long()
    pred = y[bidx, cyl, cxl, slotl]  # [B, M, 5 + C]
    sig_tx = torch.sigmoid(pred[..., 0])
    sig_ty = torch.sigmoid(pred[..., 1])

    sq_xy = box_scale * ((sig_tx - tx_t) ** 2 + (sig_ty - ty_t) ** 2)
    sq_wh = box_scale * (
        (pred[..., 2] - tw_t) ** 2 + (pred[..., 3] - th_t) ** 2
    )
    obj_pos = _bce_logits(pred[..., 4], 1.0)
    # jax.nn.one_hot: an index outside [0, C) gives a zero row.
    onehot = (targets.cls.long()[..., None]
              == torch.arange(num_cls, device=dev)).float()
    cls_bce = torch.sum(_bce_logits(pred[..., 5:], onehot), dim=-1)

    # Background objectness over the whole grid; slots whose decoded box
    # overlaps a gt above the threshold are ignored (the test shapes the
    # mask, not the gradient).
    det = decode_v3((y,), image_hw, anchor_list[grp0 : grp0 + 3])
    pred_boxes = det.boxes.detach()  # [B, G, 4] pixels
    iou_bg = iou(pred_boxes[:, :, None, :], box[:, None, :, :])  # [B, G, M]
    iou_bg = torch.where(targets.valid[:, None, :], iou_bg, 0.0)
    ignored = torch.amax(iou_bg, dim=-1) > ignore_iou  # [B, G]

    flat = (cyl * wg + cxl) * a + slotl  # [B, M]
    # Gts colliding on one (cell, anchor) slot: the first selected keeps
    # it, later ones leave ``sel`` (darknet overwrites its assignment map).
    m = flat.shape[1]
    same = (flat[:, :, None] == flat[:, None, :]) & (sel[:, None, :] > 0)
    earlier = torch.ones(m, m, dtype=torch.bool, device=dev).tril(-1)
    collided = torch.any(same & earlier, dim=-1).float()  # [B, M]
    sel = sel * (1.0 - collided)

    g = hg * wg * a
    pos = torch.zeros(b, g, device=dev).scatter_reduce(
        1, flat, sel, "amax", include_self=True)
    bg = (1.0 - pos) * (1.0 - ignored.float())  # [B, G]
    bce0 = _bce_logits(y[..., 4].reshape(b, g), 0.0)
    noobj_sum = torch.sum(bce0 * bg, dim=-1)  # [B]
    noobj_cnt = torch.sum(bg, dim=-1)

    return _ScaleTerms(sq_xy, sq_wh, obj_pos, cls_bce, sel,
                       noobj_sum, noobj_cnt)


def _all_terms(ys, targets, image_hw, anchors, ignore_iou):
    anchor_list = tuple(tuple(float(v) for v in an) for an in anchors)
    dev = ys[0].device
    anchors_arr = torch.tensor(anchor_list, dtype=torch.float32, device=dev)
    if anchors_arr.shape != (3 * len(ys), 2):
        raise ValueError(f"expected {3 * len(ys)} (w, h) anchors, got "
                         f"{tuple(anchors_arr.shape)}")
    box = targets.box
    gw = torch.clamp(box[..., 2] - box[..., 0], min=1e-3)
    gh = torch.clamp(box[..., 3] - box[..., 1], min=1e-3)
    # Best anchor by width/height IoU, both boxes centered.
    iw = torch.minimum(gw[..., None], anchors_arr[:, 0])
    ih = torch.minimum(gh[..., None], anchors_arr[:, 1])
    inter = iw * ih
    union = gw[..., None] * gh[..., None] + (
        anchors_arr[:, 0] * anchors_arr[:, 1]
    ) - inter
    best = torch.argmax(inter / (union + 1e-9), dim=-1)  # [B, M] in 0..8

    return [
        _per_scale_terms(y, s, len(ys), targets, tuple(image_hw),
                         anchors_arr, anchor_list, best, ignore_iou)
        for s, y in enumerate(ys)
    ]


def yolov3_loss(
    ys: Sequence[torch.Tensor],
    targets: YoloTargets,
    image_hw: Tuple[int, int],
    anchors: Sequence[Tuple[float, float]] = YOLOV3_ANCHORS,
    lambdas: Lambdas = Lambdas(),
    ignore_iou: float = 0.5,
    count_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, LossParts]:
    """The lambda-weighted YOLOv3 loss over the heads ``ys`` (y32, y16, y8)
    of an ``image_hw`` input, with the 9 pixel ``anchors``.  The lambdas
    map xy -> center, wh -> log size, conf -> positive objectness, noobj ->
    background objectness, cls -> class BCE.  Returns ``(total,
    LossParts)``: positive terms are means over valid gts (xy and wh over
    their two elements), noobj over background slots.  ``count_sum``
    (data parallelism, as ``yolo_loss``'s): both counts are the global
    batch's."""
    terms = _all_terms(ys, targets, image_hw, anchors, ignore_iou)
    count_sum = count_sum or (lambda t: t)

    num_boxes = torch.clamp(
        count_sum(sum(torch.sum(t.sel) for t in terms)), min=1.0)

    def pos_mean(field, scale=1.0):
        return sum(
            torch.sum(getattr(t, field) * t.sel) for t in terms
        ) / (num_boxes * scale)

    loss_xy = pos_mean("sq_xy", 2.0)
    loss_wh = pos_mean("sq_wh", 2.0)
    loss_conf = pos_mean("obj_pos")
    loss_cls = pos_mean("cls_bce")
    noobj_cnt = torch.clamp(
        count_sum(sum(torch.sum(t.noobj_cnt) for t in terms)), min=1.0)
    loss_noobj = sum(torch.sum(t.noobj_sum) for t in terms) / noobj_cnt

    parts = LossParts(loss_xy, loss_wh, loss_conf, loss_noobj, loss_cls)
    total = (
        lambdas.lambda_xy * loss_xy
        + lambdas.lambda_wh * loss_wh
        + lambdas.lambda_conf * loss_conf
        + lambdas.lambda_noobj * loss_noobj
        + lambdas.lambda_cls * loss_cls
    )
    return total, parts


def yolov3_loss_per_image(
    ys: Sequence[torch.Tensor],
    targets: YoloTargets,
    image_hw: Tuple[int, int],
    anchors: Sequence[Tuple[float, float]] = YOLOV3_ANCHORS,
    lambdas: Lambdas = Lambdas(),
    ignore_iou: float = 0.5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-image losses, each mean over the image's own gts and background
    slots (the validation semantics of ``yolo_loss_per_image``): returns
    ``(losses [B], has_box [B] bool)``, loss 0 where an image has no gt."""
    terms = _all_terms(ys, targets, image_hw, anchors, ignore_iou)

    m_i = sum(torch.sum(t.sel, dim=1) for t in terms)  # [B]
    denom = torch.clamp(m_i, min=1.0)

    def pos_mean_i(field, scale=1.0):
        return sum(
            torch.sum(getattr(t, field) * t.sel, dim=1) for t in terms
        ) / (denom * scale)

    noobj_cnt = torch.clamp(sum(t.noobj_cnt for t in terms), min=1.0)
    loss_i = (
        lambdas.lambda_xy * pos_mean_i("sq_xy", 2.0)
        + lambdas.lambda_wh * pos_mean_i("sq_wh", 2.0)
        + lambdas.lambda_conf * pos_mean_i("obj_pos")
        + lambdas.lambda_noobj * (
            sum(t.noobj_sum for t in terms) / noobj_cnt
        )
        + lambdas.lambda_cls * pos_mean_i("cls_bce")
    )
    has_box = m_i > 0
    return torch.where(has_box, loss_i, torch.zeros_like(loss_i)), has_box
