"""Target assignment (grid-cell, v1 and v2 flavors).

Port of ``odc_tpu/ops/assign.py``.  Targets are compact padded tensors
``[B, MAX_BOXES, ...]`` with a validity mask.  Each box stores the values the
reference assigner writes into its one active cell:

* ``cell`` (cy, cx) — ``int(by), int(bx)`` truncation;
* ``sig_txty`` — center offset within the cell;
* ``twth`` — v1: ``(bw/Wg, bh/Hg)`` sigmoid-space size; v2: ``(bw, bh)`` in
  grid units;
* ``box`` — raw pixel corners, ``cls`` — class index.

Two implementations with identical semantics:

* :func:`assign_numpy` — host, float64 arithmetic in the reference's
  operation order, cast to float32 at the end: bitwise-stable against the
  reference assigner;
* :func:`assign` — float32 tensors on the batch's device, vectorized (runs
  inside the train step after device augmentation; no host round trip).

:func:`densify` recovers the reference's dense per-box layout.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F


class YoloTargets(NamedTuple):
    cell: torch.Tensor      # [B, M, 2] int32 (cy, cx)
    sig_txty: torch.Tensor  # [B, M, 2] f32
    twth: torch.Tensor      # [B, M, 2] f32 (v1: sig-space wh; v2: grid-unit wh)
    box: torch.Tensor       # [B, M, 4] f32 pixel corners (x1, y1, x2, y2)
    cls: torch.Tensor       # [B, M] int32
    valid: torch.Tensor     # [B, M] bool


def _check_mode(mode: str) -> None:
    # "v3" produces v2-shaped compact targets: YOLOv3's own assignment is
    # re-derived inside its loss from box/cls/valid alone.
    if mode not in ("v1", "v2", "v3"):
        raise ValueError(f"mode must be 'v1', 'v2' or 'v3', got {mode!r}")


def assign(
    boxes: torch.Tensor,
    cls_idx: torch.Tensor,
    valid: torch.Tensor,
    image_hw: Tuple[int, int],
    mode: str = "v2",
) -> YoloTargets:
    """Vectorized assigner on the tensors' device.

    Args:
        boxes: [B, M, 4] pixel corners (padded; junk where ``~valid``).
        cls_idx: [B, M] integer class indices.
        valid: [B, M] bool.
        image_hw: (H, W); the grid is (H//32, W//32).
        mode: "v1" (sigmoid-space wh) or "v2" (grid-unit wh).
    """
    _check_mode(mode)
    h, w = image_hw
    hg, wg = h // 32, w // 32
    # Like the reference, cell size is H/(H//32): exactly 32.0 for multiples
    # of 32 but kept general.
    cell_h = h / hg
    cell_w = w / wg

    x1 = boxes[..., 0] / cell_w
    y1 = boxes[..., 1] / cell_h
    x2 = boxes[..., 2] / cell_w
    y2 = boxes[..., 3] / cell_h

    bx = (x1 + x2) / 2
    by = (y1 + y2) / 2
    bw = x2 - x1
    bh = y2 - y1

    # int() truncation in the reference; clipped to the grid for safety on
    # padded/degenerate entries.
    cx = bx.to(torch.int32).clamp(0, wg - 1)
    cy = by.to(torch.int32).clamp(0, hg - 1)

    sig_tx = bx - cx.to(bx.dtype)
    sig_ty = by - cy.to(by.dtype)

    if mode == "v1":
        twth = torch.stack([bw / wg, bh / hg], dim=-1)
    else:
        twth = torch.stack([bw, bh], dim=-1)

    return YoloTargets(
        cell=torch.stack([cy, cx], dim=-1),
        sig_txty=torch.stack([sig_tx, sig_ty], dim=-1).float(),
        twth=twth.float(),
        box=boxes.float(),
        cls=cls_idx.to(torch.int32),
        valid=valid,
    )


def assign_numpy(
    bbox_list,
    cls_idx_list,
    image_hw: Tuple[int, int],
    mode: str = "v2",
    max_boxes: int = 64,
):
    """Host assigner for one image: float64 in the reference op order, cast
    to float32 at the end.

    Returns numpy arrays shaped like one row of :class:`YoloTargets`
    (``[max_boxes, ...]``)."""
    _check_mode(mode)
    h, w = image_hw
    hg, wg = h // 32, w // 32
    cell_h = h / hg
    cell_w = w / wg

    cell = np.zeros((max_boxes, 2), np.int32)
    sig_txty = np.zeros((max_boxes, 2), np.float64)
    twth = np.zeros((max_boxes, 2), np.float64)
    box = np.zeros((max_boxes, 4), np.float64)
    cls = np.zeros((max_boxes,), np.int32)
    valid = np.zeros((max_boxes,), bool)

    n = min(len(bbox_list), max_boxes)
    for i in range(n):
        x1, y1, x2, y2 = bbox_list[i]
        x1n = x1 / cell_w
        y1n = y1 / cell_h
        x2n = x2 / cell_w
        y2n = y2 / cell_h
        bx = (x1n + x2n) / 2
        by = (y1n + y2n) / 2
        bw = x2n - x1n
        bh = y2n - y1n
        cx = int(bx)
        cy = int(by)

        cell[i] = (cy, cx)
        sig_txty[i] = (bx - cx, by - cy)
        if mode == "v1":
            twth[i] = (bw / wg, bh / hg)
        else:
            twth[i] = (bw, bh)
        box[i] = (x1, y1, x2, y2)
        cls[i] = cls_idx_list[i]
        valid[i] = True

    return (
        cell,
        sig_txty.astype(np.float32),
        twth.astype(np.float32),
        box.astype(np.float32),
        cls,
        valid,
    )


def densify(targets: YoloTargets, grid_hw: Tuple[int, int], num_cls: int):
    """Materialize the reference's dense per-box contract.

    Returns, with ``M_total = B*M`` (invalid rows are all-zero maps, like a
    reference map for a box that was never written):
        sig_txty  [M_total, Hg, Wg, 2]
        twth      [M_total, Hg, Wg, 2]
        box       [M_total, Hg, Wg, 4]
        cls_onehot[M_total, Hg, Wg, C]
        obj_mask  [M_total, Hg, Wg]
        img_id    [M_total]  (row index into the batch)
        valid     [M_total]
    """
    hg, wg = grid_hw
    b, m = targets.valid.shape
    dev = targets.valid.device
    flat = YoloTargets(*(t.reshape((b * m,) + t.shape[2:]) for t in targets))

    rows = torch.arange(hg, dtype=torch.int32, device=dev).view(1, hg, 1)
    cols = torch.arange(wg, dtype=torch.int32, device=dev).view(1, 1, wg)
    hot = (
        (rows == flat.cell[:, 0].view(-1, 1, 1))
        & (cols == flat.cell[:, 1].view(-1, 1, 1))
        & flat.valid.view(-1, 1, 1)
    )
    hotf = hot.float()[..., None]  # [M_total, Hg, Wg, 1]

    def spread(x):  # [M_total, K] -> [M_total, Hg, Wg, K]
        return hotf * x[:, None, None, :]

    onehot = F.one_hot(flat.cls.long(), num_cls).float()
    img_id = torch.arange(b, dtype=torch.int32, device=dev).repeat_interleave(m)
    return (
        spread(flat.sig_txty),
        spread(flat.twth),
        spread(flat.box),
        spread(onehot),
        hotf[..., 0],
        img_id,
        flat.valid,
    )
