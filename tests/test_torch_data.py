"""The port's data path (``odc_tpu_torch.data``) against the JAX package's:
the VOC index, the batches of ``DetectionPipeline`` and the prefetchers."""

import os
import threading
import time

import numpy as np
import pytest

import torch

from odc_tpu.data import pipeline as jpipeline
from odc_tpu.data import voc as jvoc
from odc_tpu.native import loader as native_loader
from odc_tpu_torch.data import pipeline as tpipeline
from odc_tpu_torch.native import loader as tnative_loader
from odc_tpu_torch.data import prefetch as tprefetch
from odc_tpu_torch.data import voc as tvoc


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    """One synthetic VOC tree written by the PORT and read by both."""
    root = tmp_path_factory.mktemp("voc")
    return tvoc.make_synthetic_voc(str(root), num_train=10, num_val=7, seed=3)


@pytest.fixture()
def pil_only(monkeypatch):
    """Make both packages decode and resize through PIL, their fallback
    when the C++ loader cannot be built (PIL's bilinear filters on
    downscale, the loader's cv2 scheme does not)."""
    for loader in (native_loader, tnative_loader):
        monkeypatch.setattr(loader, "available", lambda: False)
        monkeypatch.setattr(loader, "batch_available", lambda: False)


def test_synthetic_voc_and_index_equal_to_jax(voc_root, tmp_path):
    other = jvoc.make_synthetic_voc(
        str(tmp_path), num_train=10, num_val=7, seed=3
    )
    ours, theirs = tvoc.VOC(dataset_dir=voc_root), jvoc.VOC(dataset_dir=other)
    assert os.path.exists(os.path.join(voc_root, "voc_dataset.pkl"))
    assert tvoc.CLASS_LIST == jvoc.CLASS_LIST and ours.cls2idx == theirs.cls2idx
    assert ours.train_annot_list == theirs.train_annot_list
    assert ours.val_annot_list == theirs.val_annot_list
    assert [os.path.relpath(p, voc_root) for p in ours.train_img_path_list] == [
        os.path.relpath(p, other) for p in theirs.train_img_path_list
    ]
    for a, b in zip(ours.val_img_path_list, theirs.val_img_path_list):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()  # the same JPEG bytes
    # Cache hit path, and the per-sample contract.
    again = tvoc.VOC(dataset_dir=voc_root)
    assert again.train_img_path_list == ours.train_img_path_list
    idx, img, annot = ours.train_dataset[2]
    assert idx == 2 and img.dtype == np.uint8 and img.shape == (240, 320, 3)
    assert set(annot) == {"bbox_list", "lbl_list"}
    assert tvoc.dataset_supports_raw_paths(ours.train_dataset)


def test_parse_annotation_truncates_floats(tmp_path):
    p = tmp_path / "a.xml"
    p.write_text(
        "<annotation><object><name>dog</name><bndbox>"
        "<xmin>10.7</xmin><ymin>3.2</ymin><xmax>99.9</xmax><ymax>80.1</ymax>"
        "</bndbox></object></annotation>"
    )
    assert tvoc.parse_annotation(str(p)) == jvoc.parse_annotation(str(p))
    assert tvoc.parse_annotation(str(p))["bbox_list"] == [[10, 3, 99, 80]]


def _assert_batches_equal(ours, theirs):
    assert len(ours) == len(theirs)
    for bo, bt in zip(ours, theirs):
        assert bo._fields == bt._fields
        for name, a, b in zip(bo._fields, bo, bt):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize(
    "hw, mode", [((128, 160), "v2"), ((96, 96), "v1"), ((240, 320), "v2")]
)
def test_train_batches_equal_to_jax(voc_root, pil_only, hw, mode):
    """Same seed: same order, images and targets, over two epochs (the
    shuffle stream carries on), resized and at the native size."""
    kw = dict(image_hw=hw, batch_size=4, max_boxes=8, mode=mode, seed=5)
    ours = tpipeline.DetectionPipeline(
        tvoc.VOC(dataset_dir=voc_root).train_dataset, **kw
    )
    theirs = jpipeline.DetectionPipeline(
        jvoc.VOC(dataset_dir=voc_root).train_dataset, **kw
    )
    assert len(ours) == len(theirs) == 2
    for _ in range(2):
        _assert_batches_equal(list(ours), list(theirs))


class _TPerSample(tvoc.VOCDataset):
    """No raw-path flag: the pipeline decodes and resizes sample by sample."""

    def __getitem__(self, index):
        return super().__getitem__(index)


class _JPerSample(jvoc.VOCDataset):
    def __getitem__(self, index):
        return super().__getitem__(index)


@pytest.mark.parametrize("path", ["batched", "per_sample"])
def test_train_batches_with_the_loader_equal_to_jax(voc_root, path):
    """Both packages on their C++ loaders: pixels and targets bitwise over
    two epochs, through one ``decode_resize_batch`` a batch or through the
    per-sample decode and ``resize_bilinear``."""
    assert native_loader.available() and tnative_loader.available()
    kw = dict(image_hw=(128, 160), batch_size=4, max_boxes=8, seed=5)
    ours_ds = tvoc.VOC(dataset_dir=voc_root).train_dataset
    theirs_ds = jvoc.VOC(dataset_dir=voc_root).train_dataset
    if path == "per_sample":
        ours_ds = _TPerSample(ours_ds.img_path_list, ours_ds.annot_list)
        theirs_ds = _JPerSample(theirs_ds.img_path_list,
                                theirs_ds.annot_list)
    assert tvoc.dataset_supports_raw_paths(ours_ds) == (path == "batched")
    ours = tpipeline.DetectionPipeline(ours_ds, **kw)
    theirs = jpipeline.DetectionPipeline(theirs_ds, **kw)
    for _ in range(2):
        _assert_batches_equal(list(ours), list(theirs))


def test_undecodable_file_falls_back_per_file_as_jax(voc_root, tmp_path):
    """A PNG under a .jpg name in a batch: the loader rejects it, that file
    alone goes through the per-sample path (PIL decodes it), and the batch
    still equals the JAX package's."""
    from PIL import Image

    ds = tvoc.VOC(dataset_dir=voc_root).train_dataset
    paths = list(ds.img_path_list[:4])
    png = tmp_path / "png.jpg"
    with Image.open(paths[1]) as im:
        im.save(png, format="PNG")
    paths[1] = str(png)
    kw = dict(image_hw=(96, 96), batch_size=4, max_boxes=8, shuffle=False,
              prefetch=0)
    ours = list(tpipeline.DetectionPipeline(
        tvoc.VOCDataset(paths, ds.annot_list[:4]), **kw))
    theirs = list(jpipeline.DetectionPipeline(
        jvoc.VOCDataset(paths, ds.annot_list[:4]), **kw))
    rcs = tnative_loader.decode_resize_batch(paths, (96, 96),
                                             return_status=True)[2]
    assert (rcs != 0).tolist() == [False, True, False, False]
    _assert_batches_equal(ours, theirs)


def test_val_tail_batch_padded_and_equal_to_jax(voc_root, pil_only):
    kw = dict(image_hw=(64, 64), batch_size=4, shuffle=False,
              drop_remainder=False, prefetch=0)
    ours = tpipeline.DetectionPipeline(
        tvoc.VOC(dataset_dir=voc_root).val_dataset, **kw
    )
    theirs = jpipeline.DetectionPipeline(
        jvoc.VOC(dataset_dir=voc_root).val_dataset, **kw
    )
    batches = list(ours)
    _assert_batches_equal(batches, list(theirs))
    assert len(batches) == len(ours) == 2
    tail = batches[-1]
    assert tail.img_id.tolist() == [4, 5, 6, -1]
    assert not tail.valid[3].any() and not tail.image[3].any()


def test_multiscale_retarget_and_in_memory_dataset():
    """Any sequence of (index, image, annot) items is a dataset; an image
    already at the network size passes through untouched."""
    rng = np.random.default_rng(0)
    items = [
        (i, rng.integers(0, 255, (64, 64, 3), dtype=np.uint8),
         {"bbox_list": [[4, 8, 40, 50]], "lbl_list": ["dog"]})
        for i in range(4)
    ]
    pipe = tpipeline.DetectionPipeline(
        items, image_hw=(64, 64), batch_size=2, shuffle=False, prefetch=0
    )
    first = next(iter(pipe))
    np.testing.assert_array_equal(first.image[1], items[1][1])
    np.testing.assert_array_equal(first.box[0, 0], [4, 8, 40, 50])
    pipe.set_image_size((96, 128))
    again = next(iter(pipe))
    assert again.image.shape == (2, 96, 128, 3)
    np.testing.assert_allclose(again.box[0, 0], [8, 12, 80, 75])


def test_pipeline_rejects_what_is_not_ported():
    """A process index out of range and a global batch the processes cannot
    split are refused; host augmentation and sharding, ported now, are
    accepted (their parity: tests/test_torch_host_augment.py,
    tests/test_torch_parallel.py)."""
    pipe = tpipeline.DetectionPipeline(
        [], batch_size=4, process_index=1, process_count=2)
    assert pipe.local_batch_size == 2
    with pytest.raises(ValueError, match="process_index"):
        tpipeline.DetectionPipeline([], process_index=2, process_count=2)
    with pytest.raises(ValueError, match="divisible"):
        tpipeline.DetectionPipeline([], batch_size=5, process_count=2)
    augment = tpipeline.DetectionPipeline([], augment=lambda *a: a).augment
    assert augment is not None


def test_threaded_prefetch_stops_worker_when_consumer_breaks():
    produced = []

    def items():
        for i in range(100):
            produced.append(i)
            yield i

    before = threading.active_count()
    gen = tprefetch.threaded_prefetch(items, maxsize=1)
    assert next(gen) == 0
    gen.close()  # the consumer walks away
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before
    assert len(produced) < 100  # the producer stopped early


def test_threaded_prefetch_propagates_worker_error():
    def items():
        yield 1
        raise RuntimeError("decode failed")

    gen = tprefetch.threaded_prefetch(items, maxsize=2)
    assert next(gen) == 1
    with pytest.raises(RuntimeError, match="decode failed"):
        next(gen)


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_device_prefetch_yields_every_batch_as_tensors(depth):
    batches = [
        tpipeline.Batch(*(np.full((2, 3), i, dt) for dt in (
            np.uint8, np.int32, np.float32, np.float32, np.float32,
            np.int32, bool, np.int32)))
        for i in range(4)
    ]
    out = list(tprefetch.device_prefetch(batches, "cpu", depth=depth))
    assert len(out) == 4
    for i, b in enumerate(out):
        assert isinstance(b, tpipeline.Batch)
        assert b.image.dtype == torch.uint8 and b.valid.dtype == torch.bool
        assert b.cell.dtype == torch.int32 and b.box.dtype == torch.float32
        assert all(int(t.flatten()[0]) == (i if t.dtype != torch.bool else min(i, 1))
                   for t in b)
