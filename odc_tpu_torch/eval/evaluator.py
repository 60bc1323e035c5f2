"""Inference and VOC mAP evaluation.

Port of ``odc_tpu/eval/evaluator.py``.  ``Detector.detect`` is the
single-image contract: YOLOv2 runs at the image's native size, YOLOv1 and
YOLOv3 at their network size (resized in, boxes clipped to the network
frame and scaled back: a YOLOv3's top-down merges need the taps of a
32-multiple size), and all return the ``annot_pred`` dict
(bbox/lbl/conf/cls-spec-conf lists).  A YOLOv3 built with
``int8_dynamic`` evaluates in int8.

``evaluate_model`` is the per-image evaluation loop.  ``evaluate_batched``
streams fixed-size batches through one inference function, boxes rescaled
per image (a YOLOv1 only at its network size; a YOLOv3 at any 32-multiple
size); ``evaluate_batched_native``
(YOLOv2) pads (never resizes) each image to a
32-multiple bucket and runs the masked native-size forward per bucket, so
every image is scored at its native size.  All three share the AP math of
``core/ap.py``.

Host decode and resize run on a prefetch thread, through the port's C++
loader when it builds (``evaluate_batched`` then decodes and resizes each
batch in one call into its thread pool), else PIL.  Outputs are numpy.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from odc_tpu_torch.core.ap import APAccumulator, DEFAULT_LEVELS
from odc_tpu_torch.data.voc import CLASS_LIST, dataset_supports_raw_paths
from odc_tpu_torch.native import loader as native_loader
from odc_tpu_torch.ops.detect import make_infer_fn, make_native_infer_fn


def _resize_host(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of an RGB uint8 image through the native loader (the
    cv2 fixed-point scheme), or PIL without it; a no-op at ``out_hw``."""
    if img.shape[:2] == tuple(out_hw):
        return img
    if native_loader.available():
        return native_loader.resize_bilinear(img, out_hw)
    from PIL import Image

    return np.array(
        Image.fromarray(img).resize((out_hw[1], out_hw[0]), Image.BILINEAR)
    )


def _numpy(out) -> tuple:
    return tuple(o.cpu().numpy() for o in out)


class Detector:
    """A YOLOv1, YOLOv2 or YOLOv3 bound into inference functions
    (``ops/detect.py``).

    For a YOLOv2 the functions fold the fused stem's weights when they are
    built: after the model's weights change, build a new Detector."""

    def __init__(
        self,
        model,
        cls_list: Sequence[str] = tuple(CLASS_LIST),
        conf_thre: float = 0.9,
        iou_thre: float = 0.5,
        max_keep: int = 64,
        class_wise: bool = False,
        int8_neck: bool = False,
        int8_scales=None,
        int8_stem: str = "s2d",
    ) -> None:
        self.model = model
        self.cls_list = list(cls_list)
        self.conf_thre = conf_thre
        self.iou_thre = iou_thre
        self.max_keep = max_keep
        self.mode = model.mode
        if (int8_neck or int8_scales is not None) and self.mode != "v2":
            # Silently dropping the int8 config would evaluate bf16 under
            # an int8 label.
            raise ValueError(
                "int8_neck/int8_scales are YOLOv2-only (the engine "
                "hardcodes the Darknet-19/quadrant graph)"
            )
        self._make_kwargs = dict(
            class_wise=class_wise,
            int8_neck=int8_neck,
            int8_scales=int8_scales,
            int8_stem=int8_stem,
        )
        self._infer = make_infer_fn(
            self.model, self.conf_thre, self.iou_thre, self.max_keep,
            **self._make_kwargs,
        )
        self._infer_compact = None  # built on first use

    def _thresholds(self, conf_thre, iou_thre):
        return (self.conf_thre if conf_thre is None else conf_thre,
                self.iou_thre if iou_thre is None else iou_thre)

    # -- batched path -------------------------------------------------------

    def infer_batch(
        self,
        images: np.ndarray,
        conf_thre: Optional[float] = None,
        iou_thre: Optional[float] = None,
    ):
        """[B, H, W, 3] uint8 -> (boxes [B,K,4], conf [B,K], cls_scores
        [B,K,C], keep [B,K]) numpy.  The thresholds are runtime
        arguments."""
        return _numpy(
            self._infer(images, *self._thresholds(conf_thre, iou_thre)))

    def infer_batch_compact(
        self,
        images: np.ndarray,
        conf_thre: Optional[float] = None,
        iou_thre: Optional[float] = None,
    ):
        """Like :meth:`infer_batch` with per-box (label, score) computed on
        the device: (boxes [B,K,4], conf [B,K], label [B,K] int32,
        label_score [B,K], keep [B,K]), 5x less traffic to the host than
        the full class-score tensor (what the streaming mAP eval uses)."""
        if self._infer_compact is None:
            self._infer_compact = make_infer_fn(
                self.model, self.conf_thre, self.iou_thre, self.max_keep,
                compact=True, **self._make_kwargs,
            )
        return _numpy(self._infer_compact(
            images, *self._thresholds(conf_thre, iou_thre)))

    # -- single-image path ----------------------------------------------------

    def detect(self, img: np.ndarray, conf_score_thre: Optional[float] = None,
               iou_thre: Optional[float] = None) -> Dict[str, list]:
        """One RGB uint8 image -> the ``annot_pred`` dict.

        YOLOv2 runs at the image's NATIVE size: the pooling chain floors
        odd sizes and the quadrant neck drops an odd trailing row/col;
        boxes come back in native pixels, neither clipped nor resized.
        YOLOv1 and YOLOv3 run at ``model.image_size``: the image is resized
        in, the boxes are clipped to the network frame and scaled back by
        ``orig / net``."""
        orig_h, orig_w = img.shape[:2]
        resized = self.mode in ("v1", "v3")
        if resized:
            net_h, net_w = self.model.image_size
            x = _resize_host(img, (net_h, net_w))
        elif orig_h < 64 or orig_w < 64:
            raise ValueError(
                f"YOLOv2 native-size detect needs images >= 64x64 "
                f"(stride-32 grid plus the passthrough tap), got "
                f"{orig_h}x{orig_w}"
            )
        else:
            x = img
        boxes, conf, cls_scores, keep = self.infer_batch(
            x[None], conf_score_thre, iou_thre
        )
        boxes, conf, cls_scores = (
            boxes[0][keep[0]], conf[0][keep[0]], cls_scores[0][keep[0]])
        if resized:
            boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0.0, net_w - 1.0)
            boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0.0, net_h - 1.0)
            boxes = boxes * np.array([orig_w / net_w, orig_h / net_h,
                                      orig_w / net_w, orig_h / net_h])
        lbl_idx = cls_scores.argmax(-1) if len(cls_scores) else np.zeros(0, int)
        return {
            "bbox_list": boxes.tolist(),
            "lbl_list": [self.cls_list[i] for i in lbl_idx],
            "conf_score_list": conf.tolist(),
            "cls_spec_conf_score_list": (
                cls_scores.max(-1).tolist() if len(cls_scores) else []
            ),
        }


def _gt(annot):
    return (np.asarray(annot["bbox_list"], np.float64).reshape(-1, 4),
            annot["lbl_list"])


def evaluate_model(
    detector: Detector,
    dataset,
    levels: Sequence[float] = DEFAULT_LEVELS,
    dedup: bool = False,
    progress: bool = False,
) -> Dict[str, np.ndarray]:
    """Per-image evaluation loop: :meth:`Detector.detect` on every image."""
    acc = APAccumulator(detector.cls_list, levels, dedup=dedup)
    n = len(dataset)
    for i in range(n):
        _, img, annot = dataset[i]
        if progress:
            print(f"Evaluation: [{i + 1} / {n}]", end="\r")
        pred = detector.detect(img)
        acc.add_image(
            np.asarray(pred["bbox_list"], np.float64).reshape(-1, 4),
            pred["lbl_list"],
            np.asarray(pred["cls_spec_conf_score_list"], np.float64),
            *_gt(annot),
        )
    return acc.result()


def evaluate_batched(
    detector: Detector,
    dataset,
    image_hw: Tuple[int, int] = (416, 416),
    batch_size: int = 64,
    levels: Sequence[float] = DEFAULT_LEVELS,
    dedup: bool = False,
    prefetch: int = 2,
    dp=None,
) -> Dict[str, np.ndarray]:
    """Streaming batched mAP: fixed-size batches at ``image_hw`` (for a
    YOLOv1 its ``image_size``, the only size its Dense head takes) through
    one inference function, predictions rescaled to each image's original
    size.  Decode and resize run on a prefetch thread, overlapped with the
    device's inference on the previous batch: one call into the native
    loader's thread pool a batch for a dataset with raw paths (a file it
    cannot decode raises), else image by image.

    ``dp`` (a ``parallel.DataParallel``): rank ``r`` runs every
    ``world_size``-th batch from batch ``r``, the ranks exchange their
    per-image predictions, and every rank scores all of them in dataset
    order, so each returns the one-process result."""
    image_hw = tuple(image_hw)
    net_hw = tuple(detector.model.image_size)
    if detector.mode == "v1" and image_hw != net_hw:
        raise ValueError(f"a YOLOv1 evaluates at its image_size {net_hw}, "
                         f"got image_hw={image_hw}")
    acc = APAccumulator(detector.cls_list, levels, dedup=dedup)
    n = len(dataset)
    h, w = image_hw
    fast = (dataset_supports_raw_paths(dataset)
            and native_loader.batch_available())

    def load(start):
        idxs = range(start, min(start + batch_size, n))
        imgs = np.zeros((batch_size, h, w, 3), np.uint8)
        if fast:
            paths = [dataset.img_path_list[i] for i in idxs]
            decoded, src_hw = native_loader.decode_resize_batch(
                paths, image_hw)
            imgs[: len(paths)] = decoded
            return imgs, [(tuple(src_hw[j]), dataset.annot_list[i])
                          for j, i in enumerate(idxs)]
        metas = []
        for j, i in enumerate(idxs):
            _, img, annot = dataset[i]
            imgs[j] = _resize_host(img, image_hw)
            metas.append((img.shape[:2], annot))
        return imgs, metas

    starts = range(0, n, batch_size)
    if dp is not None:
        starts = starts[dp.rank::dp.world_size]

    def items():
        for start in starts:
            yield load(start)

    batches = items()
    if prefetch > 0:
        from odc_tpu_torch.data.prefetch import threaded_prefetch

        batches = threaded_prefetch(items, maxsize=prefetch)

    records = []  # (dataset index, the add_image arguments)
    for start, (imgs, metas) in zip(starts, batches):
        boxes_b, _conf_b, lbl_b, score_b, keep_b = (
            detector.infer_batch_compact(imgs)
        )
        for j, ((oh, ow), annot) in enumerate(metas):
            keep = keep_b[j]
            boxes = boxes_b[j][keep] * np.array(
                [ow / w, oh / h, ow / w, oh / h]
            )
            records.append((start + j, (
                boxes,
                [detector.cls_list[k] for k in lbl_b[j][keep]],
                score_b[j][keep],
                *_gt(annot),
            )))
    if dp is not None:
        import torch.distributed as dist

        gathered = [None] * dp.world_size
        dist.all_gather_object(gathered, records, group=dp.group)
        records = sorted((r for part in gathered for r in part),
                         key=lambda r: r[0])
    for _, args in records:
        acc.add_image(*args)
    return acc.result()


def evaluate_batched_native(
    detector: Detector,
    dataset,
    bucket_multiple: int = 32,
    batch_size: int = 8,
    levels: Sequence[float] = DEFAULT_LEVELS,
    dedup: bool = False,
    prefetch: int = 2,
) -> Dict[str, np.ndarray]:
    """Bucketed NATIVE-size streaming mAP (YOLOv2).

    Each image is PADDED (never resized) to the next ``bucket_multiple``
    in both dimensions and batched with others of its bucket; the masked
    forward and the per-image native decode (``make_native_infer_fn``)
    reproduce each image's native-size boxes.  A bucket flushes when it
    holds ``batch_size`` images; partial buckets flush at the end in
    sorted order, their empty slots given a dummy 64x64 extent.  At most
    ``#buckets x batch_size`` decoded images are pending at a time.
    ``valid_hw`` stays host numpy until the flush moves it to the device.
    """
    if detector.mode != "v2":
        raise ValueError("native-size bucketed eval is v2-only "
                         "(v1 resizes to the network size)")
    if detector._make_kwargs.get("int8_neck"):
        # The dynamic-PTQ neck rides the forward's neck_override hook,
        # which the masked forward refuses; the full engine (int8_scales)
        # has its own masked path.
        raise ValueError(
            "native-size bucketed eval does not support int8_neck; use "
            "the full engine (int8_scales) or the bf16 detector"
        )
    infer = make_native_infer_fn(
        detector.model, detector.conf_thre, detector.iou_thre,
        detector.max_keep,
        class_wise=detector._make_kwargs["class_wise"],
        int8_scales=detector._make_kwargs["int8_scales"],
        int8_stem=detector._make_kwargs["int8_stem"],
    )
    acc = APAccumulator(detector.cls_list, levels, dedup=dedup)

    def flush(bucket_hw, items):
        bh, bw = bucket_hw
        imgs = np.zeros((batch_size, bh, bw, 3), np.uint8)
        vhw = np.full((batch_size, 2), 64, np.int32)  # pad slots: dummy 64²
        for j, (img, _annot) in enumerate(items):
            h, w = img.shape[:2]
            imgs[j, :h, :w] = img
            vhw[j] = (h, w)
        boxes_b, _conf_b, lbl_b, score_b, keep_b = _numpy(infer(
            imgs, vhw, detector.conf_thre, detector.iou_thre))
        for j, (_img, annot) in enumerate(items):
            keep = keep_b[j]
            acc.add_image(
                boxes_b[j][keep],
                [detector.cls_list[k] for k in lbl_b[j][keep]],
                score_b[j][keep],
                *_gt(annot),
            )

    def items():
        for i in range(len(dataset)):
            yield dataset[i]

    source = items()
    if prefetch > 0:
        # Overlap host decode with the device's inference on flushed
        # buckets.
        from odc_tpu_torch.data.prefetch import threaded_prefetch

        source = threaded_prefetch(items, maxsize=max(1, prefetch * batch_size))

    pending: Dict[Tuple[int, int], list] = {}
    for _id, img, annot in source:
        h, w = img.shape[:2]
        if h < 64 or w < 64:
            raise ValueError(
                f"native-size v2 eval needs images >= 64x64, got {h}x{w}"
            )
        bucket = (
            -(-h // bucket_multiple) * bucket_multiple,
            -(-w // bucket_multiple) * bucket_multiple,
        )
        group = pending.setdefault(bucket, [])
        group.append((img, annot))
        if len(group) == batch_size:
            flush(bucket, pending.pop(bucket))
    for bucket in sorted(pending):
        flush(bucket, pending[bucket])
    return acc.result()
