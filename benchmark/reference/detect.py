"""Plain decode and greedy NMS for YOLOv2 and YOLOv3, and the judge of a
batch of served detections.

Decode (YOLO9000 and YOLOv3): box centre ``(sigmoid(t_xy) + cell) * stride``,
size ``anchor * exp(t_wh)``, objectness ``sigmoid(t_o)``; YOLOv2's class
probabilities are a softmax and YOLOv3's independent sigmoids; a class
score is objectness times class probability.  Candidates come out in one
flat axis per image: scale by scale (coarsest first), then row-major cells,
then anchors.  YOLOv2's anchors are in grid cells, YOLOv3's in pixels.

NMS: class-agnostic greedy suppression of the candidates whose objectness
reaches the threshold, the ``max_keep`` highest first (stable order on
ties); a candidate is dropped when a kept, higher one overlaps it with IoU
at or above the IoU threshold.

The judge (:func:`judge`) ties every served detection to the reference
candidate it was decoded from: a box's centre lies inside the grid cell of
the candidate it came from, at every scale, so the served box's centre
names the cell, and of the anchors at that cell (all scales for YOLOv3) the
one nearest in box (1 - IoU) and objectness is its candidate.  It then reads how far the
served values lie from that candidate's, which reference detections the
served set misses, and whether the served set keeps the suppression's own
guarantee: no two served boxes of one image overlap at the IoU threshold.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch

# Served pairs count as overlapping from ``iou_thre + OVERLAP_TOL``: the
# IoU of two boxes within the image rounds by under 1e-6 in float32,
# whatever the order of its operations, so a suppression that rounds in
# another order stays clear, and one that keeps a pair above the threshold
# by more than this shows.
OVERLAP_TOL = 1e-4


class Candidates(NamedTuple):
    boxes: torch.Tensor   # [N, G, 4] pixel corners
    conf: torch.Tensor    # [N, G] objectness
    score: torch.Tensor   # [N, G, C] class scores (objectness x probability)


def _cells(hg: int, wg: int, device):
    cy = torch.arange(hg, device=device, dtype=torch.float32).view(1, hg, 1, 1)
    cx = torch.arange(wg, device=device, dtype=torch.float32).view(1, 1, wg, 1)
    return cy, cx


def _decode_scale(y, anchors_px, stride_hw, softmax: bool):
    """One head [N, Hg, Wg, A, 5 + C] with pixel anchors [A, 2]."""
    n, hg, wg, a, _ = y.shape
    sh, sw = stride_hw
    cy, cx = _cells(hg, wg, y.device)
    bx = (torch.sigmoid(y[..., 0]) + cx) * sw
    by = (torch.sigmoid(y[..., 1]) + cy) * sh
    bw = anchors_px[:, 0] * torch.exp(y[..., 2])
    bh = anchors_px[:, 1] * torch.exp(y[..., 3])
    boxes = torch.stack([bx - bw / 2, by - bh / 2, bx + bw / 2, by + bh / 2], -1)
    conf = torch.sigmoid(y[..., 4])
    prob = torch.softmax(y[..., 5:], -1) if softmax else torch.sigmoid(y[..., 5:])
    score = prob * conf[..., None]
    g = hg * wg * a
    return boxes.reshape(n, g, 4), conf.reshape(n, g), score.reshape(n, g, -1)


def scales(cfg: dict) -> List[Tuple[int, int, torch.Tensor]]:
    """``(grid_h, grid_w, pixel anchors [A, 2])`` per head, in output order."""
    h, w = cfg["image_size"]
    anchors = torch.tensor(cfg["anchors"], dtype=torch.float32)
    if cfg["model"] == "YOLOv2":
        hg, wg = h // 32, w // 32
        return [(hg, wg, anchors * torch.tensor([w / wg, h / hg]))]
    out = []
    for s, stride in enumerate((32, 16, 8)):
        out.append((h // stride, w // stride, anchors[6 - 3 * s:9 - 3 * s]))
    return out


def decode(cfg: dict, heads) -> Candidates:
    """Head output(s) -> flat candidates (see the module docstring)."""
    if cfg["model"] == "YOLOv2":
        heads = (heads,)
    h, w = cfg["image_size"]
    parts = []
    for y, (hg, wg, anchors) in zip(heads, scales(cfg)):
        parts.append(_decode_scale(y.float(), anchors.to(y.device),
                                   (h / hg, w / wg), cfg["model"] == "YOLOv2"))
    return Candidates(*(torch.cat(t, 1) for t in zip(*parts)))


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Corner-format IoU, broadcast over leading dims."""
    ix = (torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0])).clamp(min=0)
    iy = (torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1])).clamp(min=0)
    inter = ix * iy
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a + area_b - inter + 1e-6)


def nms(c: Candidates, conf_thre: float, iou_thre: float, max_keep: int):
    """Greedy NMS per image -> (index [N, K] into the candidates, keep
    [N, K] bool), best first."""
    k = min(max_keep, c.conf.shape[1])
    valid = c.conf >= conf_thre
    score = torch.where(valid, c.conf, torch.full_like(c.conf, -1.0))
    order = torch.sort(score, dim=1, descending=True, stable=True).indices[:, :k]
    keep = valid.gather(1, order)
    boxes = c.boxes.gather(1, order[..., None].expand(-1, -1, 4))
    over = iou(boxes[:, :, None], boxes[:, None, :]) >= iou_thre
    for i in range(k):
        later = torch.arange(k, device=keep.device) > i
        keep = keep & ~(over[:, i] & later & keep[:, i:i + 1])
    return order, keep


def candidate_cells(cfg: dict, device) -> List[Tuple[int, int, int, int]]:
    """``(offset, grid_h, grid_w, anchors)`` of each head in the flat axis."""
    out, off = [], 0
    for hg, wg, anchors in scales(cfg):
        out.append((off, hg, wg, anchors.shape[0]))
        off += hg * wg * anchors.shape[0]
    return out


def judge(cfg: dict, ref: Candidates, served: Dict[str, torch.Tensor],
          conf_thre: float, iou_thre: float, max_keep: int) -> Dict[str, float]:
    """Judge served detections of N images against the reference's
    candidates of the same images.

    ``served``: ``boxes [N, K, 4]``, ``conf [N, K]``, ``label [N, K]``,
    ``keep [N, K]`` (the program's compact outputs).  Returns the worst gaps
    over served detections (``conf_gap``: objectness; ``size_gap``: the
    largest |log| ratio of width or height; ``label_gap``: how far the
    served label's reference score lies below the reference's best class
    at that candidate) and their means (``conf_mad``, ``size_mad``; and
    ``label_miss``, the share of served labels that are not the
    reference's best), the share of reference detections that no served
    box covers at IoU 0.5 (``missed``), the share of served detections
    whose candidate the reference puts below the threshold (``extra``),
    the share of served detections that another served detection of the
    same image overlaps at ``iou_thre`` or more (``overlap``: 0 under a
    sound suppression, see :data:`OVERLAP_TOL`), and the counts."""
    dev = ref.conf.device
    n = ref.conf.shape[0]
    boxes = served["boxes"].to(dev).float()
    keep = served["keep"].to(dev).bool()
    conf = served["conf"].to(dev).float()
    label = served["label"].to(dev).long()
    h, w = cfg["image_size"]
    cx = ((boxes[..., 0] + boxes[..., 2]) / 2).clamp(0, w - 1e-3)
    cy = ((boxes[..., 1] + boxes[..., 3]) / 2).clamp(0, h - 1e-3)
    ids = []
    for off, hg, wg, a in candidate_cells(cfg, dev):
        row = (cy / (h / hg)).long().clamp(0, hg - 1)
        col = (cx / (w / wg)).long().clamp(0, wg - 1)
        base = off + (row * wg + col) * a
        ids += [base + j for j in range(a)]
    ids = torch.stack(ids, -1)  # [N, K, anchors at the cell]
    cand = ref.boxes.gather(1, ids.reshape(n, -1, 1).expand(-1, -1, 4)).view(*ids.shape, 4)
    c_conf = ref.conf.gather(1, ids.reshape(n, -1)).view(ids.shape)
    dist = (1 - iou(boxes[..., None, :], cand)) + (conf[..., None] - c_conf).abs()
    pick = ids.gather(-1, dist.argmin(-1, keepdim=True)).squeeze(-1)  # [N, K]
    r_box = ref.boxes.gather(1, pick[..., None].expand(-1, -1, 4))
    r_conf = ref.conf.gather(1, pick)
    r_score = ref.score.gather(1, pick[..., None].expand(-1, -1, ref.score.shape[-1]))
    served_n = int(keep.sum())
    out = {"served": served_n}
    if served_n:
        wh_p = (boxes[..., 2:] - boxes[..., :2]).clamp(min=1e-6)
        wh_r = (r_box[..., 2:] - r_box[..., :2]).clamp(min=1e-6)
        size = (wh_p / wh_r).log().abs().amax(-1)
        lab = r_score.amax(-1) - r_score.gather(-1, label[..., None]).squeeze(-1)
        dconf = (conf - r_conf).abs()[keep]
        out["conf_gap"] = float(dconf.max())
        out["conf_mad"] = float(dconf.mean())
        out["size_gap"] = float(size[keep].max())
        out["size_mad"] = float(size[keep].mean())
        out["label_gap"] = float(lab[keep].max())
        out["label_miss"] = float((lab[keep] > 0).float().mean())
        out["extra"] = float((r_conf[keep] < conf_thre).float().mean())
        k = keep.shape[1]
        pair = iou(boxes[:, :, None], boxes[:, None, :]) >= iou_thre + OVERLAP_TOL
        pair &= keep[:, :, None] & keep[:, None, :]
        pair &= ~torch.eye(k, dtype=torch.bool, device=dev)
        out["overlap"] = float(pair.any(-1)[keep].float().mean())
    else:
        out.update(conf_gap=0.0, conf_mad=0.0, size_gap=0.0, size_mad=0.0,
                   label_gap=0.0, label_miss=0.0, extra=0.0, overlap=0.0)
    order, rkeep = nms(ref, conf_thre, iou_thre, max_keep)
    r_boxes = ref.boxes.gather(1, order[..., None].expand(-1, -1, 4))
    cover = iou(r_boxes[:, :, None], boxes[:, None, :]) >= 0.5
    cover = (cover & keep[:, None, :]).any(-1)
    ref_n = int(rkeep.sum())
    out["reference"] = ref_n
    out["missed"] = float((rkeep & ~cover).sum()) / max(ref_n, 1)
    return out


def served_format(c: Candidates, conf_thre: float, iou_thre: float,
                  max_keep: int):
    """The program's compact outputs computed from candidates ``c``:
    ``(boxes, conf, label, label_score, keep)``, zero where not kept."""
    order, keep = nms(c, conf_thre, iou_thre, max_keep)
    boxes = c.boxes.gather(1, order[..., None].expand(-1, -1, 4))
    conf = c.conf.gather(1, order)
    score = c.score.gather(1, order[..., None].expand(-1, -1, c.score.shape[-1]))
    label_score, label = score.max(-1)
    pad = max_keep - keep.shape[1]  # fewer candidates than max_keep
    if pad:
        boxes = torch.nn.functional.pad(boxes, (0, 0, 0, pad))
        conf, label_score = (torch.nn.functional.pad(t, (0, pad)) for t in (conf, label_score))
        label, keep = (torch.nn.functional.pad(t, (0, pad)) for t in (label, keep))
    k = keep.float()
    return (boxes * k[..., None], conf * k, label.int() * keep.int(),
            label_score * k, keep)
