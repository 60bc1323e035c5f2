"""Box decode for the YOLOv1, YOLOv2, YOLOv3 and YOLOv4 heads.

Port of ``odc_tpu/ops/decode.py`` (``Detections``, ``YOLOV2_ANCHORS``,
``YOLOV3_ANCHORS``, ``decode_v1``, ``decode_v1_preactivated``,
``decode_v2``, ``decode_v3``).  v2:
``bx = sigmoid(tx) + cx``, ``bw = p_w * exp(tw)`` with the anchors in grid
units, ``conf = sigmoid(t_o)``, ``cls_prob = softmax``, ``cls_spec = conf *
cls_prob``.  v1: the reference's sigmoid sizes, ``bw = Wg * sigmoid(tw)``,
and one softmax over the classes per cell.  v3: three heads with pixel
anchors, ``bx = (sigmoid(tx) + cx) * stride``, independent class sigmoids,
flattened to one box axis; YOLOv4 is v3 with a grid-sensitivity factor
per head (``scale_x_y``).  Corners in pixels.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from odc_tpu_torch.core.constants import device_constant

# Reference anchors, (width, height) in 13x13-grid units.
YOLOV2_ANCHORS: Tuple[Tuple[float, float], ...] = (
    (1.3221, 1.73145),
    (3.19275, 4.00944),
    (5.05587, 8.09892),
    (9.47112, 4.84053),
    (11.2364, 10.0071),
)

# YOLOv3 anchors, (width, height) in PIXELS of the network input (darknet's
# yolov3.cfg), smallest to largest; groups of 3 attach to the stride-8, 16
# and 32 heads.
YOLOV3_ANCHORS: Tuple[Tuple[float, float], ...] = (
    (10.0, 13.0), (16.0, 30.0), (33.0, 23.0),        # stride 8
    (30.0, 61.0), (62.0, 45.0), (59.0, 119.0),       # stride 16
    (116.0, 90.0), (156.0, 198.0), (373.0, 326.0),   # stride 32
)


class Detections(NamedTuple):
    """Decoded head output (v3: one flat box axis, ``[B, G, ...]``)."""

    sig_txty: torch.Tensor  # [B, Hg, Wg, A, 2]  sigmoid(tx), sigmoid(ty)
    twth: torch.Tensor      # [B, Hg, Wg, A, 2]  exp (v2) or sigmoid (v1)
    boxes: torch.Tensor     # [B, Hg, Wg, A, 4]  (x1, y1, x2, y2) in pixels
    conf: torch.Tensor      # [B, Hg, Wg, A]     sigmoid(t_o)
    cls_prob: torch.Tensor  # [B, Hg, Wg, A, C]  (v1: [B, Hg, Wg, C], per cell)
    cls_spec: torch.Tensor  # [B, Hg, Wg, A, C]  conf * cls_prob


def _grid_offsets(hg: int, wg: int, dtype, device):
    cy = torch.arange(hg, dtype=dtype, device=device).view(1, hg, 1, 1)
    cx = torch.arange(wg, dtype=dtype, device=device).view(1, 1, wg, 1)
    return cy, cx


def _corners(bx, by, bw, bh, image_hw, hg, wg):
    """Grid-unit centers/sizes -> pixel corner coords."""
    h, w = image_hw
    x1 = bx - bw / 2
    y1 = by - bh / 2
    x2 = bx + bw / 2
    y2 = by + bh / 2
    cell_h = h / hg
    cell_w = w / wg
    return torch.stack(
        [x1 * cell_w, y1 * cell_h, x2 * cell_w, y2 * cell_h], dim=-1
    )


def decode_v2(
    y: torch.Tensor,
    image_hw: Tuple[int, int],
    anchors: Sequence[Tuple[float, float]] = YOLOV2_ANCHORS,
) -> Detections:
    """Decode a YOLOv2 head output ``y`` [B, Hg, Wg, A, 5 + C] for an input
    of ``image_hw`` pixels."""
    _, hg, wg, _, _ = y.shape
    anchors_arr = device_constant(anchors, y.dtype, y.device)
    pw = anchors_arr[:, 0]
    ph = anchors_arr[:, 1]

    sig_txty = torch.sigmoid(y[..., 0:2])
    exp_twth = torch.exp(y[..., 2:4])
    conf = torch.sigmoid(y[..., 4])

    cy, cx = _grid_offsets(hg, wg, y.dtype, y.device)
    bx = sig_txty[..., 0] + cx
    by = sig_txty[..., 1] + cy
    bw = pw * exp_twth[..., 0]
    bh = ph * exp_twth[..., 1]

    boxes = _corners(bx, by, bw, bh, image_hw, hg, wg)

    cls_prob = torch.softmax(y[..., 5:], dim=-1)
    cls_spec = cls_prob * conf[..., None]

    return Detections(sig_txty, exp_twth, boxes, conf, cls_prob, cls_spec)


def _v1_boxes(sig_txty, sig_twth, image_hw, hg, wg):
    """The reference's v1 box math (``yolov1.py:298-299``): centers in the
    cell, sizes ``grid * sigmoid`` in grid units."""
    cy, cx = _grid_offsets(hg, wg, sig_txty.dtype, sig_txty.device)
    bx = sig_txty[..., 0] + cx
    by = sig_txty[..., 1] + cy
    bw = wg * sig_twth[..., 0]
    bh = hg * sig_twth[..., 1]
    return _corners(bx, by, bw, bh, image_hw, hg, wg)


def decode_v1(
    y: torch.Tensor, image_hw: Tuple[int, int], num_anchors: int = 2
) -> Detections:
    """Decode a YOLOv1 head output ``y`` [B, Hg, Wg, A * 5 + C] for an input
    of ``image_hw`` pixels: sigmoid over every box value, softmax over the
    cell's classes."""
    b, hg, wg, d = y.shape
    num_cls = d - num_anchors * 5
    box_vals = y[..., : num_anchors * 5].reshape(b, hg, wg, num_anchors, 5)
    sig = torch.sigmoid(box_vals)
    sig_txty, sig_twth, conf = sig[..., 0:2], sig[..., 2:4], sig[..., 4]
    boxes = _v1_boxes(sig_txty, sig_twth, image_hw, hg, wg)
    cls_prob = torch.softmax(y[..., -num_cls:], dim=-1)  # [B, Hg, Wg, C]
    cls_spec = cls_prob[..., None, :] * conf[..., :, None]
    return Detections(sig_txty, sig_twth, boxes, conf, cls_prob, cls_spec)


def decode_v1_preactivated(
    y: torch.Tensor, image_hw: Tuple[int, int], num_anchors: int = 2
) -> Detections:
    """Decode the legacy-draft v1 head, whose one sigmoid over the whole
    output the model already applied: box values are read as they are, and
    the class probabilities are those sigmoids (no softmax).  Box corners
    follow :func:`decode_v1`."""
    b, hg, wg, d = y.shape
    num_cls = d - num_anchors * 5
    vals = y[..., : num_anchors * 5].reshape(b, hg, wg, num_anchors, 5)
    sig_txty, sig_twth, conf = vals[..., 0:2], vals[..., 2:4], vals[..., 4]
    boxes = _v1_boxes(sig_txty, sig_twth, image_hw, hg, wg)
    cls_prob = y[..., -num_cls:]
    cls_spec = cls_prob[..., None, :] * conf[..., :, None]
    return Detections(sig_txty, sig_twth, boxes, conf, cls_prob, cls_spec)


def decode_v3(
    ys: Sequence[torch.Tensor],
    image_hw: Tuple[int, int],
    anchors: Sequence[Tuple[float, float]] = YOLOV3_ANCHORS,
    scale_x_y: Optional[Sequence[float]] = None,
) -> Detections:
    """Decode YOLOv3's heads ``ys`` = (y32, y16, y8), coarsest first, each
    [B, Hg, Wg, 3, 5 + C], into one ``Detections`` with a flat
    ``[B, sum Hg*Wg*3]`` box axis (head by head, then row-major cells, then
    anchors).  ``anchors`` are 9 (w, h) pixel priors, smallest first: the
    coarsest head takes the largest group.  ``bx = (sigmoid(tx) + cx) *
    stride``, ``bw = a_w * exp(tw)``, ``conf = sigmoid(t_o)``, class
    probabilities independent sigmoids (no softmax).

    ``scale_x_y`` (YOLOv4's grid sensitivity, one factor ``s`` a head,
    coarsest first): ``bx = (sigmoid(tx) * s - (s - 1) / 2 + cx) * stride``,
    and likewise ``by``; ``None`` keeps YOLOv3's centres, op for op."""
    h, w = image_hw
    num_scales = len(ys)
    flat: list = [[] for _ in range(6)]
    for s, y in enumerate(ys):
        b, hg, wg, a, _ = y.shape
        grp = device_constant(
            anchors[3 * (num_scales - 1 - s) : 3 * (num_scales - s)],
            y.dtype, y.device,
        )  # [3, 2] pixels
        stride_h = h / hg
        stride_w = w / wg

        sig_txty = torch.sigmoid(y[..., 0:2])
        exp_twth = torch.exp(y[..., 2:4])
        conf = torch.sigmoid(y[..., 4])
        cls_prob = torch.sigmoid(y[..., 5:])

        cy, cx = _grid_offsets(hg, wg, y.dtype, y.device)
        if scale_x_y is None:
            bx = (sig_txty[..., 0] + cx) * stride_w
            by = (sig_txty[..., 1] + cy) * stride_h
        else:
            k = float(scale_x_y[s])
            off = (k - 1.0) / 2.0
            bx = (sig_txty[..., 0] * k - off + cx) * stride_w
            by = (sig_txty[..., 1] * k - off + cy) * stride_h
        bw = grp[:, 0] * exp_twth[..., 0]
        bh = grp[:, 1] * exp_twth[..., 1]
        boxes = torch.stack(
            [bx - bw / 2, by - bh / 2, bx + bw / 2, by + bh / 2], dim=-1
        )
        cls_spec = cls_prob * conf[..., None]

        g = hg * wg * a
        for i, t in enumerate(
            (sig_txty, exp_twth, boxes, conf, cls_prob, cls_spec)
        ):
            flat[i].append(t.reshape((b, g) + t.shape[4:]))
    return Detections(*(torch.cat(parts, dim=1) for parts in flat))
