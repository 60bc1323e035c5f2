"""VOC average-precision math, a numpy copy of ``odc_tpu/core/ap.py``.

Reference rule (the JAX package's default):

* a prediction is TP at IoU level L iff ANY same-class GT has IoU >= L —
  there is **no greedy GT de-duplication** (multiple detections of one GT
  can all be TP);
* per class: sort by class-specific confidence desc, cumulative TP/FP,
  precision = tp/(tp+fp+eps), recall = tp/(num_gt+eps),
  AP = Σ reverse-cummax(precision) · Δrecall over 10 levels .50:.05:.95.

``dedup=True`` switches to the standard VOC matching (each GT consumed by
at most one detection per level, greedily in confidence order).

``legacy_grid_aps`` is the grid-cell AP of the reference's legacy YOLOv1
evaluator (no NMS).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

DEFAULT_LEVELS = (0.50, 0.55, 0.60, 0.65, 0.70, 0.75, 0.80, 0.85, 0.90, 0.95)
_EPS = 1e-6


def iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Corner IoU, broadcastable, numpy (as ``core/boxes.py::iou``)."""
    ix1 = np.maximum(a[..., 0], b[..., 0])
    iy1 = np.maximum(a[..., 1], b[..., 1])
    ix2 = np.minimum(a[..., 2], b[..., 2])
    iy2 = np.minimum(a[..., 3], b[..., 3])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    union = (
        (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
        + (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
        - inter
    )
    return inter / (union + _EPS)


class APAccumulator:
    """Streams per-image detections; computes per-class AP vectors at the
    end.  Separating accumulation from AP math lets the batched
    evaluators and the reference-style per-image loop share one code path."""

    def __init__(
        self,
        cls_list: Sequence[str],
        levels: Sequence[float] = DEFAULT_LEVELS,
        dedup: bool = False,
    ) -> None:
        self.cls_list = list(cls_list)
        self.levels = np.asarray(levels, np.float64)
        self.dedup = dedup
        self._tp: Dict[str, List[np.ndarray]] = {c: [] for c in self.cls_list}
        self._fp: Dict[str, List[np.ndarray]] = {c: [] for c in self.cls_list}
        self._conf: Dict[str, List[float]] = {c: [] for c in self.cls_list}
        self._num_gt: Dict[str, int] = {c: 0 for c in self.cls_list}

    def add_image(
        self,
        pred_boxes: np.ndarray,   # [P, 4]
        pred_labels: Sequence[str],
        pred_scores: np.ndarray,  # [P] class-specific confidence
        gt_boxes: np.ndarray,     # [G, 4]
        gt_labels: Sequence[str],
    ) -> None:
        gt_boxes = np.asarray(gt_boxes, np.float64).reshape(-1, 4)
        gt_labels = np.asarray(gt_labels)
        for c in self.cls_list:
            self._num_gt[c] += int(np.sum(gt_labels == c))

        pred_boxes = np.asarray(pred_boxes, np.float64).reshape(-1, 4)
        pred_labels = np.asarray(pred_labels)
        pred_scores = np.asarray(pred_scores, np.float64).reshape(-1)

        if self.dedup:
            self._add_image_dedup(
                pred_boxes, pred_labels, pred_scores, gt_boxes, gt_labels
            )
            return

        for box, lbl, score in zip(pred_boxes, pred_labels, pred_scores):
            same = gt_boxes[gt_labels == lbl]
            if len(same):
                ious = iou_np(same, box[None, :])  # [G_c]
                # TP at level L iff any same-class GT overlaps >= L.
                fp = (ious[:, None] < self.levels).all(0).astype(int)
            else:
                fp = np.ones(len(self.levels), int)
            self._tp[str(lbl)].append(1 - fp)
            self._fp[str(lbl)].append(fp)
            self._conf[str(lbl)].append(float(score))

    def _add_image_dedup(self, pb, pl, ps, gb, gl) -> None:
        order = np.argsort(-ps)
        nl = len(self.levels)
        used = {c: np.zeros((nl, int(np.sum(gl == c))), bool)
                for c in self.cls_list}
        for i in order:
            lbl = str(pl[i])
            same = gb[gl == lbl]
            tp = np.zeros(nl, int)
            if len(same):
                ious = iou_np(same, pb[i][None, :])
                for li, lev in enumerate(self.levels):
                    cand = np.where((ious >= lev) & ~used[lbl][li])[0]
                    if len(cand):
                        used[lbl][li][cand[np.argmax(ious[cand])]] = True
                        tp[li] = 1
            self._tp[lbl].append(tp)
            self._fp[lbl].append(1 - tp)
            self._conf[lbl].append(float(ps[i]))

    # -- AP math ------------------------------------------------------------

    def result(self) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {"level_list": self.levels}
        for c in self.cls_list:
            if not self._tp[c]:
                out[c] = np.zeros(len(self.levels))
                continue
            tp = np.vstack(self._tp[c])
            fp = np.vstack(self._fp[c])
            conf = np.asarray(self._conf[c])
            order = np.argsort(conf)[::-1]
            tp_cum = np.cumsum(tp[order], axis=0)
            fp_cum = np.cumsum(fp[order], axis=0)
            prec = tp_cum / (tp_cum + fp_cum + _EPS)
            rec = tp_cum / (self._num_gt[c] + _EPS)
            # reverse cumulative max of precision
            prec_rc = np.maximum.accumulate(prec[::-1], axis=0)[::-1]
            rec_diff = np.diff(rec, axis=0, prepend=np.zeros((1, rec.shape[1])))
            out[c] = np.sum(prec_rc * rec_diff, axis=0)
        return out

    def mean_ap(self) -> Dict[str, float]:
        """{level: mAP-at-level, "mAP": mean over levels and classes}."""
        res = self.result()
        aps = np.stack([res[c] for c in self.cls_list])  # [C, L]
        out = {
            float(lev): float(np.mean(aps[:, i]))
            for i, lev in enumerate(self.levels)
        }
        out["mAP"] = float(np.mean(aps))
        return out


def legacy_grid_aps(
    iou_batch: np.ndarray,       # [N, S, S, B]
    cls_tgt_batch: np.ndarray,   # [N, C] one-hot
    cls_score_batch: np.ndarray, # [N, S, S, B, C]
    bbox_img_id_batch: np.ndarray,  # [N]
    levels: Sequence[float] = DEFAULT_LEVELS,
) -> Dict:
    """Grid-cell-level AP without NMS — capability parity with the
    reference's legacy evaluator (``models/utils.py:341-461``, used only by
    the dead ``yolov1 temp.py`` draft): per class, every grid slot of every
    image containing that class is a prediction; a slot is TP at level L iff
    the max IoU (over that image's boxes of the class) at the slot is >= L.
    """
    c = cls_tgt_batch.shape[-1]
    out: Dict = {}
    for level in levels:
        aps_by_class = []
        for cls_idx in range(c):
            rows = np.where(cls_tgt_batch[:, cls_idx] == 1)[0]
            sel_iou = iou_batch[rows]
            sel_score = cls_score_batch[rows][:, :, :, :, cls_idx]
            sel_img = bbox_img_id_batch[rows]
            num_gt = sel_iou.shape[0]

            tp_list, fp_list, score_list = [], [], []
            for img_id in np.unique(sel_img):
                m = sel_img == img_id
                max_iou = sel_iou[m].max(0)        # [S, S, B]
                score = sel_score[m][0]            # [S, S, B]
                tp_list.append((max_iou >= level).ravel())
                fp_list.append((max_iou < level).ravel())
                score_list.append(score.ravel())

            tp = np.hstack(tp_list)
            fp = np.hstack(fp_list)
            scores = np.hstack(score_list)
            order = np.argsort(scores)[::-1]
            tp_cum = np.cumsum(tp[order])
            fp_cum = np.cumsum(fp[order])
            prec = tp_cum / (tp_cum + fp_cum)
            rec = tp_cum / num_gt
            prec_rc = np.maximum.accumulate(prec[::-1])[::-1]
            rec_diff = rec - np.hstack([[0], rec[:-1]])
            aps_by_class.append(float(np.sum(prec_rc * rec_diff)))

        out["APs by Class"] = aps_by_class
        out[level] = float(np.mean(aps_by_class))
    out["mAP"] = float(np.mean([out[l] for l in levels]))
    return out
