"""The port's reference-order host augmentation
(``odc_tpu_torch/data/host_augment.py``) against the JAX package's: the
same float64 numpy arithmetic in the same order, so under one
``np.random.Generator`` seed the pixels, boxes and labels are bitwise
equal; and a host-augmented ``DetectionPipeline`` epoch equal to the JAX
one.  Both packages resize with their C++ loaders (built at first use)."""

import numpy as np
import pytest

from odc_tpu.data import host_augment as jhost
from odc_tpu.data import pipeline as jpipeline
from odc_tpu.data import voc as jvoc
from odc_tpu.native import loader as jloader
from odc_tpu_torch.data import host_augment as thost
from odc_tpu_torch.data import pipeline as tpipeline
from odc_tpu_torch.data import voc as tvoc
from odc_tpu_torch.native import loader as tloader


@pytest.fixture(scope="module", autouse=True)
def loaders_built():
    assert tloader.available() and jloader.available()


def _scene(hw, n_boxes, seed):
    rng = np.random.default_rng(1000 + seed)
    h, w = hw
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    x1 = rng.uniform(0, w * 0.6, n_boxes)
    y1 = rng.uniform(0, h * 0.6, n_boxes)
    boxes = np.stack([x1, y1, x1 + rng.uniform(8, w * 0.4, n_boxes),
                      y1 + rng.uniform(8, h * 0.4, n_boxes)], -1)
    return img, boxes, rng.integers(0, 20, n_boxes).astype(np.int32)


@pytest.mark.parametrize("hw, seeds", [((375, 500), range(0, 25)),
                                       ((500, 375), range(25, 50))])
def test_reference_augment_bitwise_equal_to_jax(hw, seeds):
    """50 seeds over the two VOC shapes, each image with 0, 1 or 5 boxes in
    turn: every transform fires in some draw (the coins are p=0.5)."""
    for seed in seeds:
        img, boxes, labels = _scene(hw, (0, 1, 5)[seed % 3], seed)
        got = thost.reference_augment(img, boxes, labels,
                                      np.random.default_rng(seed))
        want = jhost.reference_augment(img, boxes, labels,
                                       np.random.default_rng(seed))
        for name, a, b in zip(("image", "boxes", "labels"), got, want):
            assert a.dtype == b.dtype and a.shape == b.shape, (seed, name)
            np.testing.assert_array_equal(a, b, err_msg=f"{seed} {name}")


def test_host_augmented_pipeline_epoch_equal_to_jax(tmp_path):
    """Two epochs of a host-augmented YOLOv2 pipeline at 96x96: the shuffle
    and the augmentation share one stream, as in the JAX package."""
    root = tvoc.make_synthetic_voc(str(tmp_path), num_train=8, num_val=0,
                                   seed=2)
    kw = dict(image_hw=(96, 96), batch_size=4, max_boxes=8, seed=7)
    ours = tpipeline.DetectionPipeline(
        tvoc.VOC(dataset_dir=root).train_dataset,
        augment=thost.reference_augment, **kw)
    theirs = jpipeline.DetectionPipeline(
        jvoc.VOC(dataset_dir=root).train_dataset,
        augment=jhost.reference_augment, **kw)
    for _ in range(2):
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == 2
        for bo, bt in zip(got, want):
            for name, a, b in zip(bo._fields, bo, bt):
                assert a.dtype == b.dtype and a.shape == b.shape, name
                np.testing.assert_array_equal(a, b, err_msg=name)
