"""NMS suppression: the CUDA kernel (``csrc/nms_suppress.cu``), its plain
PyTorch version, and the wrapper that picks between them by device.

Replaces ``odc_tpu/ops/pallas/nms_kernel.py::pallas_suppress``.  Input is
the candidates already sorted by descending score (sorting and top-k stay in
PyTorch, ``core/nms.py``); output the greedy keep mask, bitwise equal to the
plain version (the kernel rounds every IoU op on its own, as PyTorch does).

Bound on the card: neither bytes (about 1.2 KB per image at K = 64) nor
arithmetic, but latency: the launch and a serial walk.  The kernel runs one
CTA per image: every warp builds rows of the K x K/32 suppression bitmask
in shared memory (a lane per candidate, a ballot per word, rows of invalid
candidates skipped), then one warp walks it with the keep mask in registers
(one 32-bit word per lane), jumping from kept box to kept box.
"""

from __future__ import annotations

import torch

from odc_tpu_torch.core.boxes import pairwise_iou
from odc_tpu_torch.ops.cuda import build

MAX_K = 1024


def suppress_plain(
    boxes: torch.Tensor, valid: torch.Tensor, iou_thre: float
) -> torch.Tensor:
    """boxes [B, K, 4] f32 sorted by descending score, valid [B, K] bool ->
    keep [B, K] bool: the ``core/nms.py::_suppress`` recurrence (box j is
    dropped iff a still-kept earlier box has IoU >= ``iou_thre``)."""
    k = boxes.shape[1]
    later = torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)
    sup = (pairwise_iou(boxes, boxes) >= iou_thre) & later  # [B, K, K]
    keep = valid.clone()
    for i in range(k):
        keep &= ~(sup[:, i] & keep[:, i : i + 1])
    return keep


def _launch(boxes: torch.Tensor, valid: torch.Tensor, iou_thre: float):
    b, k, _ = boxes.shape
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    if b == 0 or k == 0:
        return keep
    lib = build.load("nms_suppress")
    with torch.cuda.device(boxes.device):
        err = lib.nms_suppress(
            boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), b, k,
            float(iou_thre), torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, "nms_suppress")
    suppress.launches += 1
    return keep


def suppress(boxes: torch.Tensor, valid: torch.Tensor, iou_thre) -> torch.Tensor:
    """Keep mask over score-sorted candidates (see :func:`suppress_plain`).

    Calls the operator ``odc_tpu_torch::nms_suppress`` (``ops.py``): a CPU
    tensor runs the plain version; a CUDA tensor launches the kernel (one
    CTA per image, K <= 1024) or raises.  Boxes must start on a 16-byte
    boundary, as the kernel reads each box as one 16-byte load.
    ``iou_thre`` is a float or a 0-d float32 CPU tensor (a runtime input of
    a captured program)."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be [B, K, 4], got {tuple(boxes.shape)}")
    if valid.shape != boxes.shape[:2] or valid.dtype != torch.bool:
        raise ValueError("valid must be a [B, K] bool tensor")
    if boxes.dtype != torch.float32:
        raise TypeError(f"boxes must be float32, got {boxes.dtype}")
    if valid.device != boxes.device:
        raise ValueError("boxes and valid must be on the same device")
    if boxes.device.type == "cuda":
        if boxes.shape[1] > MAX_K:
            raise ValueError(
                f"K={boxes.shape[1]} exceeds the kernel's {MAX_K}")
        if not (boxes.is_contiguous() and valid.is_contiguous()):
            raise ValueError("boxes and valid must be contiguous")
    elif boxes.device.type != "cpu":
        raise ValueError(f"unsupported device {boxes.device}")
    if not isinstance(iou_thre, torch.Tensor):
        iou_thre = torch.tensor(float(iou_thre), dtype=torch.float32)
    return torch.ops.odc_tpu_torch.nms_suppress(boxes, valid, iou_thre)


build.counted(suppress)
