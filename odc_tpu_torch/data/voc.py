"""Pascal VOC index + dataset (the port's own copy of
``odc_tpu/data/voc.py``).

Directory layout, split policy, cache file and per-sample contract match
the reference:

* train = VOC2012 trainval + VOC2007 trainval Annotations trees; val =
  VOC2007 test;
* per-annotation dict ``{"bbox_list": [[x1,y1,x2,y2],...], "lbl_list":
  [name,...]}`` with ``int(float(...))`` coordinate parsing;
* pickle cache at ``datasets/voc_dataset.pkl``;
* ``__getitem__ -> (index, RGB uint8 HWC ndarray, annot)``.

JPEG decode goes through the port's C++ loader (``odc_tpu_torch/native``)
when it builds, else PIL; PIL is imported inside the functions that need
it.

Also provides :func:`make_synthetic_voc` — a tiny generated VOC tree
(JPEGs + XMLs) for integration tests and smoke runs.
"""

from __future__ import annotations

import os
import pickle
import xml.etree.ElementTree as ET
from typing import Dict, List, Sequence, Tuple

import numpy as np

DATASET_DIR = "datasets"
CACHE_BASENAME = "voc_dataset.pkl"

# The 20 Pascal VOC classes.
CLASS_LIST = [
    "aeroplane", "bicycle", "bird", "boat", "bottle",
    "bus", "car", "cat", "chair", "cow",
    "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]

_SPLITS = {
    "train": [
        ("voc2012-trainval", "VOC2012"),
        ("voc2007-trainval", "VOC2007"),
    ],
    "val": [
        ("voc2007-test", "VOC2007"),
    ],
}


def _decode_jpeg(path: str) -> np.ndarray:
    """JPEG -> RGB uint8 HWC.  Native libjpeg path when available; PIL
    otherwise, and also as the fallback for files the native decoder
    rejects (non-JPEG or corrupt), so one odd file degrades gracefully
    instead of aborting an epoch."""
    from odc_tpu_torch.native import loader as native_loader

    if native_loader.available():
        try:
            return native_loader.decode_jpeg(path)
        except IOError:
            pass
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def parse_annotation(xml_path: str) -> Dict[str, list]:
    """One VOC XML -> {"bbox_list", "lbl_list"} with the reference's
    int(float(...)) coordinate truncation."""
    root = ET.parse(xml_path).getroot()
    bbox_list, lbl_list = [], []
    for obj in root.findall("object"):
        name = obj.find("name").text
        bb = obj.find("bndbox")
        coords = [
            int(float(bb.find(k).text))
            for k in ("xmin", "ymin", "xmax", "ymax")
        ]
        bbox_list.append(coords)
        lbl_list.append(name)
    return {"bbox_list": bbox_list, "lbl_list": lbl_list}


def _index_split(dataset_dir: str, split: str):
    img_paths, annots = [], []
    for subdir, year in _SPLITS[split]:
        ann_root = os.path.join(
            dataset_dir, subdir, "VOCdevkit", year, "Annotations"
        )
        for dir_path, _, file_names in os.walk(ann_root):
            for fn in sorted(file_names):
                if not fn.endswith(".xml"):
                    continue
                xml_path = os.path.join(dir_path, fn)
                img_paths.append(
                    os.path.join(
                        dir_path.replace("Annotations", "JPEGImages"),
                        fn[:-4] + ".jpg",
                    )
                )
                annots.append(parse_annotation(xml_path))
    return img_paths, annots


class VOC:
    """Builds the index, with a pickle cache; exposes train/val datasets
    and the class list/mapping the models consume."""

    def __init__(self, dataset_dir: str = DATASET_DIR) -> None:
        self.dataset_dir = dataset_dir
        self.cache_path = os.path.join(dataset_dir, CACHE_BASENAME)

        self.cls_list = CLASS_LIST
        self.cls2idx = {c: i for i, c in enumerate(self.cls_list)}

        if os.path.exists(self.cache_path):
            with open(self.cache_path, "rb") as f:
                (
                    self.train_img_path_list,
                    self.train_annot_list,
                    self.val_img_path_list,
                    self.val_annot_list,
                ) = pickle.load(f)
        else:
            self.train_img_path_list, self.train_annot_list = _index_split(
                dataset_dir, "train"
            )
            self.val_img_path_list, self.val_annot_list = _index_split(
                dataset_dir, "val"
            )
            os.makedirs(dataset_dir, exist_ok=True)
            with open(self.cache_path, "wb") as f:
                pickle.dump(
                    (
                        self.train_img_path_list,
                        self.train_annot_list,
                        self.val_img_path_list,
                        self.val_annot_list,
                    ),
                    f,
                )

        self.train_dataset = VOCDataset(
            self.train_img_path_list, self.train_annot_list
        )
        self.val_dataset = VOCDataset(
            self.val_img_path_list, self.val_annot_list
        )


def dataset_supports_raw_paths(dataset) -> bool:
    """True iff a batch loader may bypass ``__getitem__`` and read
    ``img_path_list``/``annot_list`` directly (a batched-decode fast path).

    Opt-in by declaring ``supports_raw_paths = True`` on the class.  A
    subclass that overrides ``__getitem__`` (filtering, transforms) without
    re-declaring the flag is automatically excluded: the MRO walk stops at
    the first class that defines ``__getitem__`` below any flag
    declaration."""
    for klass in type(dataset).__mro__:
        flag = vars(klass).get("supports_raw_paths")
        if flag is not None:
            return bool(flag)
        if "__getitem__" in vars(klass):
            return False
    return False


class VOCDataset:
    """Per-sample access: (index, RGB uint8 HWC, annot)."""

    supports_raw_paths = True  # __getitem__ only decodes img_path_list[i]

    def __init__(self, img_path_list: Sequence[str], annot_list: Sequence[dict]):
        self.img_path_list = list(img_path_list)
        self.annot_list = list(annot_list)

    def __getitem__(self, index: int):
        return index, _decode_jpeg(self.img_path_list[index]), self.annot_list[index]

    def __len__(self) -> int:
        return len(self.img_path_list)


def make_synthetic_voc(
    root: str,
    num_train: int = 8,
    num_val: int = 4,
    image_hw: Tuple[int, int] = (240, 320),
    seed: int = 0,
) -> str:
    """Generate a miniature VOC tree (JPEGs + XMLs) under ``root``.

    Images contain solid-color rectangles on noise; each rectangle is a
    labeled object whose color is a CLASS-DETERMINED palette entry (plus
    jitter), so the class is *learnable from pixels* — with uncorrelated
    colors a val-split mAP can never exceed ~1/num_classes of the
    localization quality, which silently voids any train/eval study on
    this data.  Returns ``root`` (pass it to ``VOC(dataset_dir=...)``).
    """
    from PIL import Image

    rng = np.random.default_rng(seed)
    h, w = image_hw

    # 20 visually-distinct class colors, away from the 0-80 background.
    grid = np.stack(
        np.meshgrid([110, 160, 210], [110, 160, 210], [110, 160, 210]),
        axis=-1,
    ).reshape(-1, 3)
    palette = grid[np.linspace(0, len(grid) - 1, len(CLASS_LIST)).astype(int)]

    plan = [("train", "voc2012-trainval", "VOC2012", num_train),
            ("val", "voc2007-test", "VOC2007", num_val)]
    for _, subdir, year, count in plan:
        ann_dir = os.path.join(root, subdir, "VOCdevkit", year, "Annotations")
        img_dir = os.path.join(root, subdir, "VOCdevkit", year, "JPEGImages")
        os.makedirs(ann_dir, exist_ok=True)
        os.makedirs(img_dir, exist_ok=True)

        for i in range(count):
            img = rng.integers(0, 80, (h, w, 3), dtype=np.uint8)
            n_obj = int(rng.integers(1, 4))
            objs = []
            for _ in range(n_obj):
                bw = int(rng.integers(40, w // 2))
                bh = int(rng.integers(40, h // 2))
                x1 = int(rng.integers(0, w - bw))
                y1 = int(rng.integers(0, h - bh))
                cls_idx = int(rng.integers(0, len(CLASS_LIST)))
                color = np.clip(
                    palette[cls_idx] + rng.integers(-20, 21, 3), 0, 255
                ).astype(np.uint8)
                img[y1 : y1 + bh, x1 : x1 + bw] = color
                cls = CLASS_LIST[cls_idx]
                objs.append((cls, x1, y1, x1 + bw, y1 + bh))

            name = f"{year.lower()}_{i:06d}"
            Image.fromarray(img).save(
                os.path.join(img_dir, name + ".jpg"), quality=90
            )

            obj_xml = "".join(
                "<object><name>{}</name><bndbox>"
                "<xmin>{}</xmin><ymin>{}</ymin>"
                "<xmax>{}</xmax><ymax>{}</ymax>"
                "</bndbox></object>".format(*o)
                for o in objs
            )
            xml = (
                f"<annotation><filename>{name}.jpg</filename>"
                f"<size><width>{w}</width><height>{h}</height>"
                f"<depth>3</depth></size>{obj_xml}</annotation>"
            )
            with open(os.path.join(ann_dir, name + ".xml"), "w") as f:
                f.write(xml)

    return root
