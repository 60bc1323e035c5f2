"""Batched detection input pipeline.

Port of ``odc_tpu/data/pipeline.py`` for one process:

* one uint8 image array per batch (normalization happens on the device, in
  the model) and compact padded targets (``ops/assign.py::assign_numpy``,
  float64 host math for bitwise parity);
* JPEG decode and resize through PIL (the JAX package's C++ loader fast
  path is not wrapped yet);
* a background prefetch thread so decoding overlaps device compute.

Multi-scale training (v2): the pipeline re-targets its static image size
per epoch through :meth:`DetectionPipeline.set_image_size`.

``process_index``/``process_count`` are accepted and validated, but only
``(0, 1)`` is supported until the data-parallel slice of the port; host
augmentation (``augment``) likewise waits for its own slice.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Sequence, Tuple

import numpy as np

from odc_tpu_torch.data.voc import CLASS_LIST
from odc_tpu_torch.ops.assign import assign_numpy


class Batch(NamedTuple):
    """Everything the train step consumes: host numpy out of the pipeline,
    tensors after ``device_prefetch`` (static shapes)."""

    image: np.ndarray     # [B, H, W, 3] uint8
    cell: np.ndarray      # [B, M, 2] int32
    sig_txty: np.ndarray  # [B, M, 2] f32
    twth: np.ndarray      # [B, M, 2] f32
    box: np.ndarray       # [B, M, 4] f32
    cls: np.ndarray       # [B, M] int32
    valid: np.ndarray     # [B, M] bool
    img_id: np.ndarray    # [B] int32 (dataset indices)


def _resize_with_boxes(img, boxes, out_hw):
    """Bilinear resize + box rescale; a no-op for an image already at
    ``out_hw``."""
    h, w = img.shape[:2]
    oh, ow = out_hw
    if (h, w) != (oh, ow):
        from PIL import Image

        img = np.asarray(Image.fromarray(img).resize((ow, oh), Image.BILINEAR))
        if len(boxes):
            boxes = np.asarray(boxes, np.float64) * np.array(
                [ow / w, oh / h, ow / w, oh / h]
            )
    return img, np.asarray(boxes, np.float64).reshape(-1, 4)


class DetectionPipeline:
    """Epoch iterator producing static-shape :class:`Batch` objects.

    ``dataset`` is any sequence whose items are ``(index, RGB uint8 HWC
    array, {"bbox_list": ..., "lbl_list": ...})``, such as
    :class:`odc_tpu_torch.data.voc.VOCDataset`."""

    def __init__(
        self,
        dataset,
        image_hw: Tuple[int, int] = (416, 416),
        batch_size: int = 32,
        max_boxes: int = 64,
        mode: str = "v2",
        shuffle: bool = True,
        augment=None,
        cls_list: Sequence[str] = tuple(CLASS_LIST),
        seed: int = 0,
        drop_remainder: bool = True,
        prefetch: int = 2,
        process_index: int = 0,
        process_count: int = 1,
    ) -> None:
        if augment is not None:
            raise NotImplementedError(
                "host augmentation is not ported yet (it comes with the "
                "host-augment slice); use the in-step device augmentation "
                "(Trainer(augment_cfg=AugmentConfig()))"
            )
        if not 0 <= process_index < process_count:
            raise ValueError(
                f"process_index {process_index} not in [0, {process_count})"
            )
        if batch_size % process_count:
            raise ValueError(
                f"global batch {batch_size} not divisible by "
                f"process_count {process_count}"
            )
        if process_count != 1:
            raise NotImplementedError(
                "sharded pipelines (process_count > 1) come with the "
                "data-parallel slice of the port"
            )
        self.dataset = dataset
        self.image_hw = tuple(image_hw)
        self.batch_size = batch_size
        self.max_boxes = max_boxes
        self.mode = mode
        self.shuffle = shuffle
        self.cls_list = list(cls_list)
        self.cls2idx = {c: i for i, c in enumerate(self.cls_list)}
        self.drop_remainder = drop_remainder
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count
        self.rng = np.random.default_rng(seed)

    def set_image_size(self, image_hw: Tuple[int, int]) -> None:
        """Re-target the static image size (multi-scale training)."""
        self.image_hw = tuple(image_hw)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    # -- sample/batch construction ----------------------------------------

    def _load_sample(self, idx: int):
        _img_id, img, annot = self.dataset[idx]
        boxes = np.asarray(annot["bbox_list"], np.float64).reshape(-1, 4)
        labels = np.asarray(
            [self.cls2idx[c] for c in annot["lbl_list"]], np.int32
        )
        img, boxes = _resize_with_boxes(img, boxes, self.image_hw)
        return img, boxes, labels

    def _make_batch(self, indices) -> Batch:
        # Short tail batches (drop_remainder=False) are PADDED to the full
        # static batch size: padded rows have zero images, no valid boxes,
        # and img_id == -1.  Every loss term is masked by box validity, so
        # padded rows contribute nothing at eval.  NOT safe for training:
        # zero images would still feed BatchNorm batch statistics — Trainer
        # rejects drop_remainder=False train pipelines.
        b = self.batch_size
        m = self.max_boxes
        h, w = self.image_hw
        image = np.zeros((b, h, w, 3), np.uint8)
        cell = np.zeros((b, m, 2), np.int32)
        sig_txty = np.zeros((b, m, 2), np.float32)
        twth = np.zeros((b, m, 2), np.float32)
        box = np.zeros((b, m, 4), np.float32)
        cls = np.zeros((b, m), np.int32)
        valid = np.zeros((b, m), bool)
        img_ids = np.full((b,), -1, np.int32)

        for i, idx in enumerate(indices):
            img, boxes, labels = self._load_sample(int(idx))
            image[i] = img
            img_ids[i] = idx
            (
                cell[i], sig_txty[i], twth[i], box[i], cls[i], valid[i]
            ) = assign_numpy(
                boxes, labels, self.image_hw, mode=self.mode, max_boxes=m
            )

        return Batch(image, cell, sig_txty, twth, box, cls, valid, img_ids)

    # -- iteration ----------------------------------------------------------

    def _batch_indices(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        bs = self.batch_size
        stop = (len(order) // bs) * bs if self.drop_remainder else len(order)
        for start in range(0, stop, bs):
            yield order[start : start + bs]

    def _batches(self) -> Iterator[Batch]:
        for idxs in self._batch_indices():
            yield self._make_batch(idxs)

    def __iter__(self) -> Iterator[Batch]:
        if self.prefetch <= 0:
            return self._batches()

        from odc_tpu_torch.data.prefetch import threaded_prefetch

        return threaded_prefetch(self._batches, maxsize=self.prefetch)
