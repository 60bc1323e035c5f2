"""The port's YOLOv1 evaluation (``Detector`` in v1 mode, ``evaluate_batched``
at the network size, ``core/ap.py::legacy_grid_aps``) and the trainer's mAP
hook on a YOLOv1, against the JAX package on the CPU, f32, full width at
96x96 (grid 3), with the forward (GoogLeNet and the head) at that size.

Weights: ``test_torch_yolov1.jax_v1_init`` (jitted flax inits) carried into
the port through the bridge, BN calibrated on the set's images resized to
96x96, dropout off.  Images: synthetic VOC JPEGs at 375x500, 500x375 and
333x500, resized on both sides through the C++ loaders and, in the
``pil_only`` cases, through PIL (the fallback of both).  The conf threshold sits in the largest gap between the
candidates' confidences, so ulp-level differences cannot change which
boxes survive."""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from odc_tpu.core import ap as jap
from odc_tpu.eval import evaluator as jeval
from odc_tpu.models.backbones.googlenet import (
    GoogLeNetBackbone as JaxGoogLeNet,
)
from odc_tpu.native import loader as native_loader
from odc_tpu_torch.native import loader as tnative_loader
from odc_tpu_torch.config import TrainConfig
from odc_tpu_torch.core import ap as tap
from odc_tpu_torch.data.pipeline import DetectionPipeline
from odc_tpu_torch.data.voc import VOC, VOCDataset, make_synthetic_voc
from odc_tpu_torch.eval import (
    Detector, evaluate_batched, evaluate_batched_native,
)
from odc_tpu_torch.models.convert_jax import load_jax_yolov1
from odc_tpu_torch.models.yolov1 import YOLOv1
from odc_tpu_torch.ops.augment import AugmentConfig
from odc_tpu_torch.train import trainer as ttrainer
from test_torch_yolov1 import jax_v1_init
from torch_port_helpers import calibrate_bn, gap_threshold

NET = (96, 96)
GRID = 3
# (height, width, images) of the synthetic set: VOC's usual shapes.
SIZES = [(375, 500, 2), (500, 375, 1), (333, 500, 2)]
# The forward tolerance of test_torch_yolov2 / tests/test_e2e_parity.py.
RTOL, ATOL = 1e-3, 2e-3


def _kwargs(**kw):
    return dict(num_grid_cell_in_height=GRID, num_grid_cell_in_width=GRID,
                image_size=NET, **kw)


class _ListDataset:
    def __init__(self, items):
        self.items = list(items)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """(dataset, port model, JAX model, JAX variables, conf threshold, the
    resized images and the JAX head and backbone outputs on them)."""
    root = tmp_path_factory.mktemp("voc_v1")
    items = []
    for k, (h, w, n) in enumerate(SIZES):
        sub = str(root / f"s{k}")
        make_synthetic_voc(sub, num_train=0, num_val=n, image_hw=(h, w),
                           seed=k)
        val = VOC(dataset_dir=sub).val_dataset
        items += [(len(items), *val[i][1:]) for i in range(len(val))]
    resized = np.stack([jeval._resize_host(img, NET) for _, img, _ in items])
    jmodel, init = jax_v1_init(NET)
    model = YOLOv1(**_kwargs(dropout_rate=0.0), device="cpu")
    load_jax_yolov1(model, init)
    variables = calibrate_bn(model.eval(), resized)
    jv = jax.tree.map(jnp.asarray, variables)

    def apply(v, x):
        return jmodel.apply(v, x, capture_intermediates=lambda mdl, _: (
            isinstance(mdl, JaxGoogLeNet)))

    y, inter = jax.jit(apply)(jv, jnp.asarray(resized))
    y = np.asarray(y)
    feat = np.asarray(inter["intermediates"]["GoogLeNetBackbone_0"]
                      ["__call__"][0])
    conf = 1 / (1 + np.exp(-y[..., 4:10:5].astype(np.float64)))
    thre = gap_threshold(conf, conf.size // 8, conf.size // 2)
    # Ground truth: the synthetic rectangles, plus two of each image's own
    # detections with their labels on each resize (the C++ loader's, then
    # PIL's: the random network's detections move with the resize), so
    # several classes score AP > 0 on either.
    det = Detector(model, conf_thre=thre)
    preds = [det.detect(img) for _, img, _ in items]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tnative_loader, "available", lambda: False)
        pil_preds = [det.detect(img) for _, img, _ in items]
    gt_items = []
    for (idx, img, annot), pred, pil in zip(items, preds, pil_preds):
        gt_items.append((idx, img, {
            "bbox_list": (annot["bbox_list"] + pred["bbox_list"][:2]
                          + pil["bbox_list"][:2]),
            "lbl_list": (annot["lbl_list"] + pred["lbl_list"][:2]
                         + pil["lbl_list"][:2])}))
    return dict(dataset=_ListDataset(gt_items), model=model, jmodel=jmodel,
                jv=jv, thre=thre, resized=resized, y=y, feat=feat)


@pytest.fixture()
def pil_only(monkeypatch):
    """Make both packages resize through PIL, their fallback when the C++
    loader cannot be built."""
    for loader in (native_loader, tnative_loader):
        monkeypatch.setattr(loader, "available", lambda: False)
        monkeypatch.setattr(loader, "batch_available", lambda: False)


def test_forward_matches_jax(scene):
    """GoogLeNet [5, 3, 3, 1024] and the head [5, 3, 3, 30] at 96x96
    against the JAX model's, rtol 1e-3 and atol 2e-3."""
    x = torch.tensor(scene["resized"])
    with torch.no_grad():
        feat = scene["model"].backbone(x).numpy()
        y = scene["model"](x).numpy()
    n = len(scene["resized"])
    assert feat.shape == scene["feat"].shape == (n, GRID, GRID, 1024)
    assert y.shape == scene["y"].shape == (n, GRID, GRID, 30)
    assert scene["feat"].std() > 0.1 and scene["y"].std() > 0.1
    np.testing.assert_allclose(feat, scene["feat"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(y, scene["y"], rtol=RTOL, atol=ATOL)


def test_detect_matches_jax(scene, pil_only):
    """``Detector.detect`` at 375x500, 500x375 and 333x500: labels equal,
    confidences and scores within 2e-5, boxes within the head tolerance
    carried through decode (d x1 <= cell * (d tx / 4 + Wg * d tw / 8),
    d t <= ATOL + RTOL |t|), the cell (32 px) and the inverse resize (up
    to 500 / 96)."""
    det = Detector(scene["model"], conf_thre=scene["thre"])
    jdet = jeval.Detector(scene["jmodel"], scene["jv"],
                          conf_thre=scene["thre"])
    d_t = ATOL + RTOL * np.abs(scene["y"]).max()
    box_atol = d_t * (NET[0] / GRID) * (0.25 + GRID / 8) * 500 / NET[0]
    kept = 0
    for _, img, _ in scene["dataset"].items:
        got, ref = det.detect(img), jdet.detect(img)
        assert got["lbl_list"] == ref["lbl_list"]
        kept += len(got["lbl_list"])
        for key in ("conf_score_list", "cls_spec_conf_score_list"):
            np.testing.assert_allclose(got[key], ref[key], rtol=0, atol=2e-5)
        boxes = np.asarray(got["bbox_list"]).reshape(-1, 4)
        np.testing.assert_allclose(
            boxes, np.asarray(ref["bbox_list"]).reshape(-1, 4), rtol=0,
            atol=box_atol)
        h, w = img.shape[:2]
        # Clipped to the network frame, then scaled to the image.
        assert (boxes >= 0).all()
        assert (boxes[:, 0::2] <= (NET[1] - 1) * w / NET[1] + 1e-3).all()
        assert (boxes[:, 1::2] <= (NET[0] - 1) * h / NET[0] + 1e-3).all()
    assert 0 < kept < 2 * GRID * GRID * len(scene["dataset"])


def test_detect_with_the_loader_matches_jax(scene):
    """``test_detect_matches_jax`` with both packages resizing through their
    C++ loaders (the threshold's gap was found on the loader's resize)."""
    assert native_loader.available() and tnative_loader.available()
    test_detect_matches_jax(scene, None)


def test_evaluate_batched_matches_jax(scene, pil_only):
    """The slice as a whole: the port's ``evaluate_batched`` at the
    model's size gives the JAX package's mAP vectors within rtol 1e-6 on
    the same set, weights and threshold."""
    det = Detector(scene["model"], conf_thre=scene["thre"])
    jdet = jeval.Detector(scene["jmodel"], scene["jv"],
                          conf_thre=scene["thre"])
    ours = evaluate_batched(det, scene["dataset"], image_hw=NET,
                            batch_size=4)
    ref = jeval.evaluate_batched(jdet, scene["dataset"], image_hw=NET,
                                 batch_size=4)
    np.testing.assert_array_equal(ours["level_list"], ref["level_list"])
    for c in det.cls_list:
        np.testing.assert_allclose(ours[c], ref[c], rtol=1e-6, atol=1e-9,
                                   err_msg=c)
    assert sum(bool(ref[c].any()) for c in det.cls_list) >= 2


def test_evaluate_batched_with_the_loader_matches_jax(scene):
    """``test_evaluate_batched_matches_jax`` with both C++ loaders on."""
    assert native_loader.available() and tnative_loader.available()
    test_evaluate_batched_matches_jax(scene, None)


def test_v1_evaluation_refusals(scene):
    """A YOLOv1 is scored at its network size only: the bucketed native
    evaluator and another ``image_hw`` (the default 416x416 too) are
    refused."""
    det = Detector(scene["model"], conf_thre=0.5)
    with pytest.raises(ValueError, match="v2-only"):
        evaluate_batched_native(det, scene["dataset"])
    for kw in (dict(image_hw=(128, 128)), {}):
        with pytest.raises(ValueError, match="image_size"):
            evaluate_batched(det, scene["dataset"], **kw)


def test_legacy_grid_aps_matches_jax():
    """On ``tests/test_ap.py``'s inputs: the same numbers, exactly."""
    rng = np.random.default_rng(11)
    n, s, b, c = 12, 3, 2, 4
    iou = rng.uniform(0, 1, (n, s, s, b))
    cls_tgt = np.eye(c)[rng.integers(0, c, n)]
    cls_score = rng.uniform(0, 1, (n, s, s, b, c))
    img_id = rng.integers(0, 5, n)
    ours = tap.legacy_grid_aps(iou, cls_tgt, cls_score, img_id)
    ref = jap.legacy_grid_aps(iou, cls_tgt, cls_score, img_id)
    assert ours == ref
    assert ours["mAP"] > 0 and len(ours["APs by Class"]) == c


@pytest.fixture()
def ckpts(tmp_path):
    """A checkpoint folder emptied after the test, passed or failed: a v1
    train state at 64x64 is 180 MB on disk and pytest keeps the temporary
    folders of its last three runs."""
    folder = tmp_path / "ckpts"
    yield folder
    for path in folder.glob("*.ckpt"):
        path.unlink()


def test_trainer_map_hook_on_yolov1(tmp_path, ckpts):
    """A YOLOv1 (dropout 0.5, device augmentation) through ``Trainer.fit``
    for two epochs with ``eval_map_every=1``: each epoch writes a
    ``map_eval`` row and the state moved; the trainer's generator fed the
    dropout (training without one raises)."""
    make_synthetic_voc(str(tmp_path / "voc"), num_train=4, num_val=4, seed=3)
    voc = VOC(dataset_dir=str(tmp_path / "voc"))
    hw = (64, 64)
    train = DetectionPipeline(
        VOCDataset(voc.train_img_path_list, voc.train_annot_list), hw, 4,
        max_boxes=8, mode="v1", seed=0)
    val = DetectionPipeline(
        VOCDataset(voc.val_img_path_list, voc.val_annot_list), hw, 4,
        max_boxes=8, mode="v1", shuffle=False, drop_remainder=False)
    config = TrainConfig(learning_rate_list=[1e-3], num_epoch_list=[2],
                         batch_size=4, max_boxes=8, multiscale_sizes=())
    model = YOLOv1(num_grid_cell_in_height=2, num_grid_cell_in_width=2,
                   image_size=hw, device="cpu", seed=1)
    fc2 = model.fc2.weight.detach().clone()
    trainer = ttrainer.Trainer(model, train, val, config, str(ckpts),
                               augment_cfg=AugmentConfig(), eval_map_every=1,
                               eval_map_conf_thre=0.01)
    assert trainer.mode == "v1"
    state, history = trainer.fit()
    assert state.step == 2 and not torch.equal(model.fc2.weight, fc2)
    assert all(np.isfinite(v).all() for v in history.values())
    rows = [json.loads(line)
            for line in (ckpts / "metrics.jsonl").read_text().splitlines()]
    assert [r["kind"] for r in rows] == ["train_epoch", "val_epoch",
                                        "map_eval"] * 2
    for r in rows[2::3]:
        assert 0.0 <= r["map_50_95"] <= r["map_50"]
    assert (ckpts / "best_map_model.ckpt").exists()
    batch = next(iter(train))
    with pytest.raises(ValueError, match="torch.Generator"):
        model.train()(torch.as_tensor(batch.image))
