"""Batched detection input pipeline.

Port of ``odc_tpu/data/pipeline.py``:

* one uint8 image array per batch (normalization happens on the device, in
  the model) and compact padded targets (``ops/assign.py::assign_numpy``,
  float64 host math for bitwise parity);
* JPEG decode and resize through the port's C++ loader (``native/``: libjpeg
  and the cv2 fixed-point bilinear) when it builds, else PIL; without host
  augmentation one call into the loader's thread pool decodes and resizes
  a whole batch;
* optional host augmentation (``augment``, e.g.
  ``data/host_augment.py::reference_augment``) on each native image before
  the resize;
* a background prefetch thread so decoding overlaps device compute.

Multi-scale training (v2): the pipeline re-targets its static image size
per epoch through :meth:`DetectionPipeline.set_image_size`.

Data parallelism: ``batch_size`` stays the GLOBAL batch; process
``process_index`` of ``process_count`` yields only its contiguous
``batch_size // process_count`` slice of every seed-aligned global batch.
"""

from __future__ import annotations

from typing import Callable, Iterator, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from odc_tpu_torch.data.voc import CLASS_LIST, dataset_supports_raw_paths
from odc_tpu_torch.native import loader as native_loader
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
    """cv2-convention bilinear resize (PIL's without the loader) + box
    rescale; a no-op for an image already at ``out_hw``."""
    h, w = img.shape[:2]
    oh, ow = out_hw
    if (h, w) != (oh, ow):
        if native_loader.available():
            img = native_loader.resize_bilinear(img, (oh, ow))
        else:
            from PIL import Image

            img = np.asarray(
                Image.fromarray(img).resize((ow, oh), Image.BILINEAR))
        if len(boxes):
            boxes = np.asarray(boxes, np.float64) * np.array(
                [ow / w, oh / h, ow / w, oh / h]
            )
    return img, np.asarray(boxes, np.float64).reshape(-1, 4)


AugmentFn = Callable[
    [np.ndarray, np.ndarray, np.ndarray, np.random.Generator],
    Tuple[np.ndarray, np.ndarray, np.ndarray],
]


class DetectionPipeline:
    """Epoch iterator producing static-shape :class:`Batch` objects.

    ``dataset`` is any sequence whose items are ``(index, RGB uint8 HWC
    array, {"bbox_list": ..., "lbl_list": ...})``, such as
    :class:`odc_tpu_torch.data.voc.VOCDataset`.  ``augment`` (an
    :data:`AugmentFn`) runs on each native image, drawing from the
    pipeline's generator, before the resize."""

    def __init__(
        self,
        dataset,
        image_hw: Tuple[int, int] = (416, 416),
        batch_size: int = 32,
        max_boxes: int = 64,
        mode: str = "v2",
        shuffle: bool = True,
        augment: Optional[AugmentFn] = None,
        cls_list: Sequence[str] = tuple(CLASS_LIST),
        seed: int = 0,
        drop_remainder: bool = True,
        prefetch: int = 2,
        process_index: int = 0,
        process_count: int = 1,
    ) -> None:
        if not 0 <= process_index < process_count:
            raise ValueError(
                f"process_index {process_index} not in [0, {process_count})"
            )
        if batch_size % process_count:
            raise ValueError(
                f"global batch {batch_size} not divisible by "
                f"process_count {process_count}"
            )
        self.dataset = dataset
        self.image_hw = tuple(image_hw)
        self.batch_size = batch_size
        self.max_boxes = max_boxes
        self.mode = mode
        self.shuffle = shuffle
        self.augment = augment
        self.cls_list = list(cls_list)
        self.cls2idx = {c: i for i, c in enumerate(self.cls_list)}
        self.drop_remainder = drop_remainder
        self.prefetch = prefetch
        # The shuffle stream is shared (the same order in every process);
        # the augment stream is per process (each augments its own
        # samples).  One process keeps one stream for both.
        self.process_index = process_index
        self.process_count = process_count
        self.local_batch_size = batch_size // process_count
        if process_count > 1:
            self._order_rng = np.random.default_rng(seed)
            self.rng = np.random.default_rng([seed, process_index])
        else:
            self.rng = self._order_rng = np.random.default_rng(seed)

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
        labels = self._labels(annot)
        if self.augment is not None:
            img, boxes, labels = self.augment(img, boxes, labels, self.rng)
        img, boxes = _resize_with_boxes(img, boxes, self.image_hw)
        return img, boxes, labels

    def _labels(self, annot) -> np.ndarray:
        return np.asarray(
            [self.cls2idx[c] for c in annot["lbl_list"]], np.int32)

    def _make_batch(self, indices) -> Batch:
        # Short tail batches (drop_remainder=False) are PADDED to the full
        # static batch size: padded rows have zero images, no valid boxes,
        # and img_id == -1.  Every loss term is masked by box validity, so
        # padded rows contribute nothing at eval.  NOT safe for training:
        # zero images would still feed BatchNorm batch statistics — Trainer
        # rejects drop_remainder=False train pipelines.
        b = self.local_batch_size
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

        for i, (idx, (boxes, labels)) in enumerate(
                zip(indices, self._load_batch_images(indices, image))):
            img_ids[i] = idx
            (
                cell[i], sig_txty[i], twth[i], box[i], cls[i], valid[i]
            ) = assign_numpy(
                boxes, labels, self.image_hw, mode=self.mode, max_boxes=m
            )

        return Batch(image, cell, sig_txty, twth, box, cls, valid, img_ids)

    def _load_batch_images(self, indices, image_out: np.ndarray):
        """Fill ``image_out[:len(indices)]`` and return per-sample
        ``(boxes, labels)``.

        Fast path (no host augmentation, a dataset with raw paths, the
        loader built): ONE call into the C++ thread pool decodes and
        resizes the whole batch off the GIL; its resize and box rescale are
        bitwise those of the per-sample path.  A file the loader rejects
        (non-JPEG or corrupt) falls back to the per-sample path alone."""
        h, w = self.image_hw
        fast = (self.augment is None
                and dataset_supports_raw_paths(self.dataset)
                and native_loader.batch_available())
        if fast:
            paths = [self.dataset.img_path_list[i] for i in indices]
            imgs, src_hw, rcs = native_loader.decode_resize_batch(
                paths, (h, w), return_status=True)
            image_out[: len(indices)] = imgs
        out = []
        for i, idx in enumerate(indices):
            if not fast or rcs[i]:
                # boxes network-scaled by _load_sample's resize
                img, boxes, labels = self._load_sample(int(idx))
                image_out[i] = img
                out.append((boxes, labels))
                continue
            annot = self.dataset.annot_list[idx]
            boxes = np.asarray(annot["bbox_list"], np.float64).reshape(-1, 4)
            sh, sw = int(src_hw[i, 0]), int(src_hw[i, 1])
            if (sh, sw) != (h, w) and len(boxes):
                boxes = boxes * np.array([w / sw, h / sh, w / sw, h / sh])
            out.append((boxes, self._labels(annot)))
        return out

    # -- iteration ----------------------------------------------------------

    def _batch_indices(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._order_rng.shuffle(order)
        bs = self.batch_size
        lb = self.local_batch_size
        stop = (len(order) // bs) * bs if self.drop_remainder else len(order)
        for start in range(0, stop, bs):
            chunk = order[start : start + bs]
            # This process's contiguous slice of the global batch: short or
            # empty on a padded tail (drop_remainder=False), so every
            # process yields the same number of batches, which lockstep
            # collectives need.
            first = self.process_index * lb
            yield chunk[first : first + lb]

    def _batches(self) -> Iterator[Batch]:
        for idxs in self._batch_indices():
            yield self._make_batch(idxs)

    def __iter__(self) -> Iterator[Batch]:
        if self.prefetch <= 0:
            return self._batches()

        from odc_tpu_torch.data.prefetch import threaded_prefetch

        return threaded_prefetch(self._batches, maxsize=self.prefetch)
