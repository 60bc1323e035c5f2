"""The port's VOC mAP evaluation (``odc_tpu_torch/core/ap.py``,
``odc_tpu_torch/eval``) against the JAX package's on the CPU: the AP math
on random predictions, the ``detect`` contract, the per-image loop against
the bucketed native-size evaluator, and the slice as a whole, where both
packages' ``evaluate_batched_native`` and ``evaluate_batched`` score the
same synthetic odd-size set with the same weights.

Full-width YOLOv2 with bridged JAX weights, BN calibrated on the set.  The
packages decode and resize through their C++ loaders, and in the
``pil_only`` cases both through PIL (their fallback).  Thresholds sit in
the largest gap between candidate confidences (as
``chip_smoke.py::_gap_threshold`` does), so ulp-level differences between
the frameworks, or between a masked and a native-size run, cannot change
which boxes survive; the mAP vectors are then held within rtol 1e-6."""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from odc_tpu.core import ap as jap
from odc_tpu.eval import evaluator as jeval
from odc_tpu.native import loader as native_loader
from odc_tpu_torch.native import loader as tnative_loader
from odc_tpu_torch.core import ap as tap
from odc_tpu_torch.data.voc import VOC, VOCDataset, make_synthetic_voc
from odc_tpu_torch.eval import (
    Detector, evaluate_batched, evaluate_batched_native, evaluate_model,
)
from torch_port_helpers import (
    calibrated_yolov2, gap_threshold, pad_to_bucket, port_model,
)

# Synthetic VOC images at three odd sizes inside one 96 x 128 bucket (one
# of them fills it); make_synthetic_voc needs sides of at least 82.
SIZES = [(85, 101), (96, 128), (83, 117)]
BUCKET = (96, 128)
ODD_SIZES = [(70, 100), (96, 96), (100, 70), (65, 130), (90, 90), (96, 128)]


class _ListDataset:
    """A dataset over in-memory (img_id, img, annot) triples."""

    def __init__(self, items):
        self.items = list(items)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _native_confs(model, images):
    """Confidences of every candidate each image's native-size run has."""
    with torch.no_grad():
        return np.concatenate([
            torch.sigmoid(model(torch.tensor(img[None]))[..., 4]).numpy().ravel()
            for img in images])


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The synthetic set (two val images a size), the bridged model, and a
    gap threshold over the candidates of both evaluators' inputs."""
    root = tmp_path_factory.mktemp("voc_eval")
    items, paths = [], []
    for k, hw in enumerate(SIZES):
        sub = str(root / f"s{k}")
        make_synthetic_voc(sub, num_train=0, num_val=2, image_hw=hw, seed=k)
        val = VOC(dataset_dir=sub).val_dataset
        items += [(len(items), *val[i][1:]) for i in range(len(val))]
        paths += val.img_path_list
    padded, _ = pad_to_bucket([img for _, img, _ in items], BUCKET)
    jmodel, variables = calibrated_yolov2(padded)
    model = port_model(variables)
    resized = np.stack([jeval._resize_host(img, BUCKET) for _, img, _ in items])
    conf = np.concatenate([_native_confs(model, [i[1] for i in items]),
                           _native_confs(model, resized)])
    thre = gap_threshold(conf, len(conf) // 10, len(conf) // 3)
    # Ground truth: the synthetic rectangles, plus two of each image's own
    # native detections with their labels, so several classes score AP > 0.
    det = Detector(model, conf_thre=thre, max_keep=16)
    gt_items = []
    for idx, img, annot in items:
        pred = det.detect(img)
        gt_items.append((idx, img, {
            "bbox_list": annot["bbox_list"] + pred["bbox_list"][:2],
            "lbl_list": annot["lbl_list"] + pred["lbl_list"][:2]}))
    return dict(dataset=_ListDataset(gt_items), model=model, jmodel=jmodel,
                jv=jax.tree.map(jnp.asarray, variables), thre=thre,
                paths=paths)


@pytest.fixture()
def pil_only(monkeypatch):
    """Make both packages resize through PIL, their fallback when the C++
    loader cannot be built."""
    for loader in (native_loader, tnative_loader):
        monkeypatch.setattr(loader, "available", lambda: False)
        monkeypatch.setattr(loader, "batch_available", lambda: False)


# -- AP math --------------------------------------------------------------


def _random_case(seed, n_imgs=8, cls_list=("cat", "dog", "bird", "cow")):
    """Random GT and predictions: jittered copies of GTs (duplicates among
    them), random boxes, images without predictions and images without
    GT; "cow" is never in the ground truth."""
    rng = np.random.default_rng(seed)
    images = []
    for i in range(n_imgs):
        g = 0 if i == 1 else int(rng.integers(1, 4))
        gt = rng.uniform(0, 80, (g, 4))
        gt[:, 2:] = gt[:, :2] + rng.uniform(10, 40, (g, 2))
        gl = [cls_list[k] for k in rng.integers(0, 3, g)]
        pb, pl = [], []
        for _ in range(0 if i == 2 else int(rng.integers(1, 6))):
            if rng.random() < 0.6 and g:
                j = int(rng.integers(0, g))
                pb.append(gt[j] + rng.normal(0, 4, 4))
                pl.append(gl[j] if rng.random() < 0.8
                          else cls_list[int(rng.integers(0, 4))])
            else:
                box = rng.uniform(0, 80, 4)
                box[2:] = box[:2] + rng.uniform(10, 40, 2)
                pb.append(box)
                pl.append(cls_list[int(rng.integers(0, 4))])
        images.append((np.asarray(pb).reshape(-1, 4), pl,
                       rng.random(len(pb)), gt, gl))
    return images, list(cls_list)


@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ap_accumulator_matches_jax(seed, dedup):
    images, cls_list = _random_case(seed)
    ours = tap.APAccumulator(cls_list, dedup=dedup)
    ref = jap.APAccumulator(cls_list, dedup=dedup)
    for case in images:
        ours.add_image(*case)
        ref.add_image(*case)
    got, want = ours.result(), ref.result()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert ours.mean_ap() == ref.mean_ap()
    assert not got["cow"].any() and got["cat"].any()


def test_iou_np_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 50, (10, 4))
    a[:, 2:] += a[:, :2]
    b = rng.uniform(0, 50, (10, 4))
    b[:, 2:] += b[:, :2]
    np.testing.assert_array_equal(tap.iou_np(a, b), jap.iou_np(a, b))
    np.testing.assert_array_equal(tap.iou_np(a[:, None], b[None]),
                                  jap.iou_np(a[:, None], b[None]))


def test_duplicates_and_missing_classes():
    """The no-dedup rule counts two detections of one GT as TP (recall 2,
    AP 2), ``dedup=True`` only one; a class with GT and no detection scores
    0."""
    gt = np.array([[0, 0, 10, 10]], np.float64)
    preds = np.array([[0, 0, 10, 10], [0.5, 0, 10.5, 10]], np.float64)
    for dedup, want in ((False, 2.0), (True, 1.0)):
        acc = tap.APAccumulator(["x", "y"], levels=[0.5], dedup=dedup)
        acc.add_image(preds, ["x", "x"], np.array([0.9, 0.8]), gt, ["x"])
        acc.add_image(np.zeros((0, 4)), [], np.zeros(0), gt, ["y"])
        res = acc.result()
        assert res["x"][0] == pytest.approx(want, abs=1e-5)
        assert res["y"][0] == 0


# -- the evaluators ---------------------------------------------------------


def test_detect_contract(scene):
    det = Detector(scene["model"], conf_thre=scene["thre"], max_keep=16)
    _, img, _ = scene["dataset"][0]
    pred = det.detect(img)
    assert set(pred) == {"bbox_list", "lbl_list", "conf_score_list",
                         "cls_spec_conf_score_list"}
    n = len(pred["bbox_list"])
    assert n > 0 and all(len(b) == 4 for b in pred["bbox_list"])
    assert (len(pred["lbl_list"]) == len(pred["conf_score_list"])
            == len(pred["cls_spec_conf_score_list"]) == n)
    assert set(pred["lbl_list"]) <= set(det.cls_list)
    assert min(pred["conf_score_list"]) >= scene["thre"]


def test_evaluate_batched_native_matches_evaluate_model(scene):
    """Bucketed native-size streaming mAP equals the per-image loop on an
    odd-size set that spans several buckets, with partial buckets flushed
    at the tail."""
    model = scene["model"]
    rng = np.random.default_rng(5)
    items = []
    for i, (h, w) in enumerate(ODD_SIZES):
        img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        items.append((i, img, {
            "bbox_list": [[w * 0.1, h * 0.1, w * 0.6, h * 0.7],
                          [w * 0.3, h * 0.4, w * 0.9, h * 0.9]],
            "lbl_list": ["dog", "cat"]}))
    conf = _native_confs(model, [img for _, img, _ in items])
    thre = gap_threshold(conf, len(conf) // 10, len(conf) // 3)
    det = Detector(model, conf_thre=thre, max_keep=16)
    ref = evaluate_model(det, _ListDataset(items))
    ours = evaluate_batched_native(det, _ListDataset(items), batch_size=2)
    np.testing.assert_array_equal(ours["level_list"], ref["level_list"])
    for c in det.cls_list:
        np.testing.assert_allclose(ours[c], ref[c], rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("evaluator", ["native", "batched"])
def test_evaluators_match_jax(scene, pil_only, evaluator):
    """The slice as a whole: the port's mAP vectors equal the JAX
    package's on the same set, weights and threshold.  The native run
    flushes a full bucket of 4 and a partial one with two 64x64 pad
    slots."""
    dataset, thre = scene["dataset"], scene["thre"]
    det = Detector(scene["model"], conf_thre=thre, max_keep=16)
    jdet = jeval.Detector(scene["jmodel"], scene["jv"], conf_thre=thre,
                          max_keep=16)
    if evaluator == "native":
        ours = evaluate_batched_native(det, dataset, batch_size=4)
        ref = jeval.evaluate_batched_native(jdet, dataset, batch_size=4)
    else:
        ours = evaluate_batched(det, dataset, image_hw=BUCKET, batch_size=4)
        ref = jeval.evaluate_batched(jdet, dataset, image_hw=BUCKET,
                                     batch_size=4)
    np.testing.assert_array_equal(ours["level_list"], ref["level_list"])
    for c in det.cls_list:
        np.testing.assert_allclose(ours[c], ref[c], rtol=1e-6, atol=1e-9,
                                   err_msg=c)
    assert sum(bool(ref[c].any()) for c in det.cls_list) >= 2


@pytest.mark.parametrize("source", ["jpeg_paths", "in_memory"])
def test_evaluate_batched_with_the_loader_matches_jax(scene, source):
    """Both packages on their C++ loaders: from the JPEG paths (one
    ``decode_resize_batch`` a batch) or from decoded images (the loader's
    ``resize_bilinear``), the mAP vectors agree within rtol 1e-6."""
    assert native_loader.available() and tnative_loader.available()
    dataset, thre = scene["dataset"], scene["thre"]
    if source == "jpeg_paths":
        dataset = VOCDataset(scene["paths"],
                             [annot for _, _, annot in dataset.items])
    det = Detector(scene["model"], conf_thre=thre, max_keep=16)
    jdet = jeval.Detector(scene["jmodel"], scene["jv"], conf_thre=thre,
                          max_keep=16)
    ours = evaluate_batched(det, dataset, image_hw=BUCKET, batch_size=4)
    ref = jeval.evaluate_batched(jdet, dataset, image_hw=BUCKET, batch_size=4)
    np.testing.assert_array_equal(ours["level_list"], ref["level_list"])
    for c in det.cls_list:
        np.testing.assert_allclose(ours[c], ref[c], rtol=1e-6, atol=1e-9,
                                   err_msg=c)
    assert sum(bool(ref[c].any()) for c in det.cls_list) >= 2


def test_evaluate_batched_native_refusals(scene):
    """An ``int8_neck`` detector (the masked forward has no neck hook), a
    model other than YOLOv2 and images under 64x64 are refused."""
    model = scene["model"]
    det = Detector(model, conf_thre=0.3, max_keep=16, int8_neck=True)
    with pytest.raises(ValueError, match="int8"):
        evaluate_batched_native(det, _ListDataset([]))
    with pytest.raises(ValueError, match="v2-only"):
        evaluate_batched_native(types.SimpleNamespace(mode="v1"),
                                _ListDataset([]))
    small = np.zeros((63, 80, 3), np.uint8)
    det = Detector(model, conf_thre=0.3, max_keep=16)
    with pytest.raises(ValueError, match="64x64"):
        evaluate_batched_native(
            det, _ListDataset([(0, small, {"bbox_list": [], "lbl_list": []})]))
    with pytest.raises(ValueError, match="64x64"):
        det.detect(small)


def test_detector_refuses_models_not_ported():
    """The YOLOv2 int8 paths are refused on the other models, as in JAX:
    a YOLOv3's int8 is its own ``int8_dynamic``, a YOLOv1 has none."""
    yolov3 = type("YOLOv3", (), {"mode": "v3"})()
    with pytest.raises(ValueError, match="YOLOv2-only"):
        Detector(yolov3, int8_scales=np.ones((22, 2)))
    yolov1 = type("YOLOv1", (), {"mode": "v1"})()
    with pytest.raises(ValueError, match="YOLOv2-only"):
        Detector(yolov1, int8_neck=True)
