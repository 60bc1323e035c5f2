"""The port's YOLOv3 training and evaluation (``losses/yolov3_loss.py``, the
v3 train and eval steps, ``Detector`` in v3 mode, ``evaluate_batched``,
``python -m odc_tpu_torch.train --model YOLOv3``) against the JAX package
on the CPU, f32, full width at 64x64.

The loss is held on random heads (no model): an ordinary batch, an image
without boxes, two gts on one (cell, anchor) slot, and objectness logits
above 20, where ``F.softplus`` would switch to the identity.  Weights of
the model tests come from ``test_torch_yolov3.v3_setup`` (the port's
seeded init, BN calibrated on eight images, carried into JAX)."""

import copy
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from odc_tpu.data.pipeline import Batch as JBatch
from odc_tpu.eval import evaluator as jeval
from odc_tpu.losses import yolov3_loss as jloss
from odc_tpu.losses.yolo_loss import Lambdas as JLambdas
from odc_tpu.native import loader as native_loader
from odc_tpu_torch.native import loader as tnative_loader
from odc_tpu.ops.assign import YoloTargets as JTargets
from odc_tpu.ops.assign import assign_numpy
from odc_tpu.ops.decode import YOLOV3_ANCHORS
from odc_tpu.train import trainer as jtrainer
from odc_tpu_torch.config import TRAIN_CONFIG
from odc_tpu_torch.data.pipeline import Batch
from odc_tpu_torch.data.prefetch import device_prefetch
from odc_tpu_torch.data.voc import VOC, make_synthetic_voc
from odc_tpu_torch.eval import (
    Detector, evaluate_batched, evaluate_batched_native,
)
from odc_tpu_torch.eval.evaluator import _resize_host
from odc_tpu_torch.losses import yolov3_loss as tloss
from odc_tpu_torch.losses.yolo_loss import Lambdas
from odc_tpu_torch.models.convert_jax import (
    jax_from_train_state, train_state_from_jax,
)
from odc_tpu_torch.ops.assign import YoloTargets
from odc_tpu_torch.train import trainer as ttrainer
from test_torch_yolov3 import v3_setup
from torch_port_helpers import gap_threshold, run_python

HW = (64, 64)
# 3x the CLI child's 19.5 s in a full tier-1 run (CHANGES.md).
CLI_LIMIT_S = 58
_V3 = TRAIN_CONFIG["YOLOv3"]["VOC2012"]
LAMBDAS = (_V3.lambda_xy, _V3.lambda_wh, _V3.lambda_conf, _V3.lambda_noobj,
           _V3.lambda_cls)


# -- the loss ----------------------------------------------------------------


def _loss_case():
    """Random heads for a 96x128 input (3 images) and targets: image 0 has
    four boxes of several sizes, image 1 none, image 2 two identical gts
    (one (cell, anchor) slot) and a third; some objectness logits are
    above 20."""
    hw = (96, 128)
    rng = np.random.default_rng(7)
    ys = [rng.normal(0, 1.5, (3, hw[0] // s, hw[1] // s, 3, 25))
          .astype(np.float32) for s in (32, 16, 8)]
    ys[2][0, :2, :2, :, 4] = 25.0
    ys[0][2, 0, 0, :, 4] = 30.0
    m = 6
    box = np.zeros((3, m, 4), np.float32)
    cls = np.zeros((3, m), np.int32)
    valid = np.zeros((3, m), bool)
    rows = {0: [[4, 6, 20, 30], [30, 10, 90, 80], [60, 40, 70, 52],
                [0, 0, 128, 96]],
            2: [[40, 30, 64, 70], [40, 30, 64, 70], [10, 50, 50, 90]]}
    for b, boxes in rows.items():
        for j, bb in enumerate(boxes):
            box[b, j] = bb
            cls[b, j] = rng.integers(0, 20)
            valid[b, j] = True
    return hw, ys, box, cls, valid


def _targets(cls_, box, cls, valid, as_array):
    z = np.zeros(box.shape[:2] + (2,), np.float32)
    return cls_(cell=as_array(z.astype(np.int32)), sig_txty=as_array(z),
                twth=as_array(z), box=as_array(box), cls=as_array(cls),
                valid=as_array(valid))


def test_loss_matches_jax():
    """``yolov3_loss`` against the JAX package's: the total and its five
    parts within rtol 1e-5, the gradient of the total with respect to each
    head within rtol 1e-4 (atol 1e-4 of the head's largest gradient); the
    collision drops the second gt (10 valid gts train 9 slots) and the
    empty image adds background terms only."""
    hw, ys, box, cls, valid = _loss_case()
    lam = Lambdas(*LAMBDAS)
    jt = _targets(JTargets, box, cls, valid, jnp.asarray)

    def jtotal(heads):
        return jloss.yolov3_loss(heads, jt, hw, lambdas=JLambdas(*LAMBDAS))

    (jtot, jparts), jgrads = jax.jit(jax.value_and_grad(
        jtotal, has_aux=True))(tuple(jnp.asarray(y) for y in ys))
    heads = [torch.tensor(y, requires_grad=True) for y in ys]
    tt = _targets(YoloTargets, box, cls, valid, torch.tensor)
    tot, parts = tloss.yolov3_loss(heads, tt, hw, lambdas=lam)
    tot.backward()
    np.testing.assert_allclose(float(tot.detach()), float(jtot), rtol=1e-5)
    for name, a, b in zip(parts._fields, parts, jparts):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=1e-5,
                                   err_msg=name)
        assert float(a.detach()) > 0, name
    for h, g in zip(heads, jgrads):
        g = np.asarray(g)
        np.testing.assert_allclose(h.grad.numpy(), g, rtol=1e-4,
                                   atol=1e-4 * np.abs(g).max())
    terms = tloss._all_terms(heads, tt, hw, YOLOV3_ANCHORS, 0.5)
    assert int(sum(float(t.sel.sum()) for t in terms)) == valid.sum() - 1


def test_loss_per_image_matches_jax():
    """``yolov3_loss_per_image``: per-image losses within rtol 1e-5, the
    image without boxes at 0 with ``has_box`` False."""
    hw, ys, box, cls, valid = _loss_case()
    ref, jhas = jax.jit(lambda heads, t: jloss.yolov3_loss_per_image(
        heads, t, hw, lambdas=JLambdas(*LAMBDAS)))(
        [jnp.asarray(y) for y in ys],
        _targets(JTargets, box, cls, valid, jnp.asarray))
    got, has = tloss.yolov3_loss_per_image(
        [torch.tensor(y) for y in ys],
        _targets(YoloTargets, box, cls, valid, torch.tensor), hw,
        lambdas=Lambdas(*LAMBDAS))
    np.testing.assert_array_equal(has.numpy(), np.asarray(jhas))
    assert has.tolist() == [True, False, True] and float(got[1]) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


def test_loss_of_a_batch_without_boxes_is_background_only():
    """No gt at all: every positive part is 0 (not NaN) and the total is
    the weighted background term."""
    hw, ys, box, cls, _ = _loss_case()
    valid = np.zeros(box.shape[:2], bool)
    tot, parts = tloss.yolov3_loss(
        [torch.tensor(y) for y in ys],
        _targets(YoloTargets, box, cls, valid, torch.tensor), hw,
        lambdas=Lambdas(*LAMBDAS))
    assert float(parts.xy) == float(parts.wh) == float(parts.cls) == 0.0
    assert float(parts.conf) == 0.0 and float(parts.noobj) > 0
    np.testing.assert_allclose(float(tot), LAMBDAS[3] * float(parts.noobj),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="9"):
        tloss.yolov3_loss([torch.tensor(y) for y in ys],
                          _targets(YoloTargets, box, cls, valid,
                                   torch.tensor), hw,
                          anchors=YOLOV3_ANCHORS[:6])


# -- the train and eval steps ------------------------------------------------

MOMENTUM, WD = 0.9, 5e-4
METRICS = ("loss", "loss_xy", "loss_wh", "loss_conf", "loss_noobj", "loss_cls")


def _v3_batch(seed, b=4, m=8):
    """A [b, 64, 64, 3] batch with 1-3 boxes an image, ``Batch`` order."""
    rng = np.random.default_rng(seed)
    h, w = HW
    image = rng.integers(0, 255, (b, h, w, 3), dtype=np.uint8)
    rows = []
    for _ in range(b):
        n = int(rng.integers(1, 4))
        x1 = rng.uniform(0, w - 30, n)
        y1 = rng.uniform(0, h - 30, n)
        boxes = np.stack([x1, y1, x1 + rng.uniform(6, 29, n),
                          y1 + rng.uniform(6, 29, n)], -1)
        rows.append(assign_numpy(boxes, rng.integers(0, 20, n), HW,
                                 mode="v3", max_boxes=m))
    fields = [np.stack([r[i] for r in rows]) for i in range(6)]
    return (image, *fields, np.arange(b, dtype=np.int32))


def _rel_l2(got, ref):
    """||got - ref|| / ||ref|| over all leaves, summed in float64."""
    num = den = 0.0
    for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        d = np.subtract(g, r, dtype=np.float64).ravel()
        r = np.asarray(r, np.float64).ravel()
        num += d @ d
        den += r @ r
    return (num / den) ** 0.5


def _pre_bn_bias(path) -> bool:
    """A conv bias followed by a batch-statistics BN (every ConvBnLeaky's,
    each merge's ``Conv_0``): its gradient is zero analytically (BN takes
    the batch mean out), so its update is weight decay plus round-off."""
    keys = [k.key for k in path]
    return keys[-2:] == ["Conv_0", "bias"] and any(
        k.startswith(("ConvBnLeaky", "_LateralMerge")) for k in keys[:-2])


def _worst_update(ttree, jtree, init):
    """The largest, over parameter leaves other than the pre-BN conv
    biases, of ||dt - dj|| / ||dj|| of the two updates (after - before,
    float64)."""
    worst = 0.0
    for (path, t), j, i in zip(jax.tree_util.tree_flatten_with_path(ttree)[0],
                               jax.tree.leaves(jtree), jax.tree.leaves(init)):
        if _pre_bn_bias(path):
            continue
        dj = np.subtract(j, i, dtype=np.float64)
        dt = np.subtract(t, i, dtype=np.float64)
        worst = max(worst, float(np.linalg.norm(dt - dj)
                                 / np.linalg.norm(dj)))
    return worst


def test_one_train_step_matches_jax():
    """One v3 step (momentum 0.9, weight decay 5e-4, the v3 lambdas) from a
    bridged init at 64x64: the loss and its five parts within rtol 1e-4,
    the updated parameters within 1e-5 relative l2, the BN running
    statistics within 1e-5; the update itself, leaf by leaf, within 5e-2
    relative l2 of JAX's (measured 2.7e-2 at worst, a BN scale in the last
    residual: a flipped LeakyReLU sign moves every upstream gradient, as
    for v1 and v2), the 72 pre-BN conv biases left out of that (their
    gradient is zero analytically, so round-off is all their update
    differs by: up to half of a 2e-8 update); the 1x1 head outputs'
    momentum within 1e-3 (measured 3.1e-4); the train state crosses the
    bridge back leaf for leaf."""
    _, jmodel, variables, model = v3_setup()
    arrays = _v3_batch(5)
    lr = 1e-4
    jstep = jtrainer.make_train_step(
        jmodel, "v3", JLambdas(*LAMBDAS), YOLOV3_ANCHORS, momentum=MOMENTUM,
        weight_decay=WD)
    jstate = jtrainer.TrainState.create(jax.tree.map(jnp.asarray, variables))
    init = jax.tree.map(np.asarray, {
        "params": jstate.params, "batch_stats": jstate.batch_stats,
        "momentum": jstate.momentum, "step": jstate.step})
    jstate, jm = jstep(
        jstate, JBatch(*(jnp.asarray(a) for a in arrays[:-1]), arrays[-1]),
        jnp.float32(lr), jax.random.key(0))
    jtree = jax.tree.map(np.asarray, {
        "params": jstate.params, "batch_stats": jstate.batch_stats,
        "momentum": jstate.momentum, "step": jstate.step})

    state = ttrainer.TrainState(copy.deepcopy(model))
    state.load_state_dict(train_state_from_jax(init))
    tstep = ttrainer.make_train_step(
        "v3", Lambdas(*LAMBDAS), YOLOV3_ANCHORS, momentum=MOMENTUM,
        weight_decay=WD)
    batch = next(device_prefetch([Batch(*arrays)], "cpu"))
    state, tm = tstep(state, batch, lr, torch.Generator().manual_seed(0))
    ttree = jax_from_train_state(state.state_dict())

    for name in METRICS:
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=1e-4, err_msg=name)
    assert all(float(tm[name]) > 0 for name in METRICS)
    assert int(ttree["step"]) == int(jtree["step"]) == 1
    assert _rel_l2(ttree["params"], jtree["params"]) < 1e-5
    assert _worst_update(ttree["params"], jtree["params"],
                         init["params"]) < 5e-2
    assert _rel_l2(ttree["batch_stats"], jtree["batch_stats"]) < 1e-5
    for name in ("Conv_0", "Conv_1", "Conv_2"):
        assert _rel_l2(ttree["momentum"][name], jtree["momentum"][name]) < 1e-3
    back = train_state_from_jax(jtree)
    again = jax_from_train_state(back)
    assert jax.tree.structure(again) == jax.tree.structure(jtree)
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(jtree), jax.tree.leaves(again)))


@pytest.mark.parametrize("val_loss_mode", ["per_image", "batched"])
def test_eval_step_is_the_v3_loss(val_loss_mode):
    """The v3 eval step in eval mode: ``per_image`` gives (sum of
    per-image losses, images with boxes) and ``batched`` the batch loss,
    each equal to the JAX loss functions on the port's own heads (rtol
    1e-5)."""
    images, _, _, model = v3_setup()
    arrays = _v3_batch(6)
    arrays = (images[:4],) + arrays[1:]
    batch = next(device_prefetch([Batch(*arrays)], "cpu"))
    step = ttrainer.make_eval_step("v3", Lambdas(*LAMBDAS), YOLOV3_ANCHORS,
                                   val_loss_mode=val_loss_mode)
    got = step(ttrainer.TrainState(model), batch)
    with torch.no_grad():
        ys = [jnp.asarray(y.numpy()) for y in model(batch.image)]
    jt = JTargets(*(jnp.asarray(a) for a in arrays[1:7]))
    if val_loss_mode == "per_image":
        losses, has = jax.jit(lambda y, t: jloss.yolov3_loss_per_image(
            y, t, HW, lambdas=JLambdas(*LAMBDAS)))(ys, jt)
        np.testing.assert_allclose(float(got[0]), float(jnp.sum(losses)),
                                   rtol=1e-5)
        assert float(got[1]) == float(jnp.sum(has)) == 4
    else:
        ref, _ = jax.jit(lambda y, t: jloss.yolov3_loss(
            y, t, HW, lambdas=JLambdas(*LAMBDAS)))(ys, jt)
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


def test_train_step_rejects_missing_anchors():
    with pytest.raises(ValueError, match="9"):
        ttrainer.make_train_step("v3", Lambdas())
    with pytest.raises(ValueError, match="mode"):
        ttrainer.make_train_step("v4", Lambdas())


# -- evaluation --------------------------------------------------------------

# (height, width, images) of the synthetic set: VOC's usual shapes.
SIZES = [(375, 500, 2), (500, 375, 1), (333, 500, 2)]


class _ListDataset:
    def __init__(self, items):
        self.items = list(items)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """(dataset, port model, JAX model and variables, conf threshold): the
    synthetic JPEGs, with two of each image's own detections added to its
    ground truth so that several classes score AP > 0; the threshold in
    the largest gap of the port's candidate confidences on the resized
    images (the JAX heads are within 7e-5)."""
    root = tmp_path_factory.mktemp("voc_v3")
    items = []
    for k, (h, w, n) in enumerate(SIZES):
        sub = str(root / f"s{k}")
        make_synthetic_voc(sub, num_train=0, num_val=n, image_hw=(h, w),
                           seed=k)
        val = VOC(dataset_dir=sub).val_dataset
        items += [(len(items), *val[i][1:]) for i in range(len(val))]
    _, jmodel, variables, model = v3_setup()
    with pytest.MonkeyPatch.context() as mp:
        # The threshold and the detections were found on PIL's resize (the
        # port's only one before its C++ loader).
        mp.setattr(tnative_loader, "available", lambda: False)
        resized = np.stack([_resize_host(img, HW) for _, img, _ in items])
        with torch.no_grad():
            conf = model.decode(model(torch.tensor(resized))).conf.numpy()
        thre = gap_threshold(conf, conf.size // 8, conf.size // 2)
        det = Detector(model, conf_thre=thre)
        preds = [det.detect(img) for _, img, _ in items]
    gt_items = []
    for (idx, img, annot), pred in zip(items, preds):
        gt_items.append((idx, img, {
            "bbox_list": annot["bbox_list"] + pred["bbox_list"][:2],
            "lbl_list": annot["lbl_list"] + pred["lbl_list"][:2]}))
    return dict(dataset=_ListDataset(gt_items), model=model, jmodel=jmodel,
                jv=jax.tree.map(jnp.asarray, variables), thre=thre)


@pytest.fixture()
def pil_only(monkeypatch):
    """Make both packages resize through PIL, their fallback when the C++
    loader cannot be built."""
    for loader in (native_loader, tnative_loader):
        monkeypatch.setattr(loader, "available", lambda: False)
        monkeypatch.setattr(loader, "batch_available", lambda: False)


def test_detector_v3_contract(scene):
    """``Detector.detect`` on a YOLOv3 takes the v1 contract: the image
    resized to the network size (64x64) in, the boxes of
    ``make_infer_fn`` on that input clipped to the network frame and
    scaled by ``orig / net`` out; labels and scores follow the kept
    boxes."""
    det = Detector(scene["model"], conf_thre=scene["thre"])
    kept = 0
    for _, img, _ in scene["dataset"].items:
        h, w = img.shape[:2]
        got = det.detect(img)
        x = _resize_host(img, HW)[None]
        boxes, conf, cls, keep = det.infer_batch(x)
        want = boxes[0][keep[0]]
        want[:, 0::2] = np.clip(want[:, 0::2], 0, HW[1] - 1) * w / HW[1]
        want[:, 1::2] = np.clip(want[:, 1::2], 0, HW[0] - 1) * h / HW[0]
        np.testing.assert_allclose(
            np.asarray(got["bbox_list"]).reshape(-1, 4), want, rtol=1e-6)
        np.testing.assert_array_equal(got["conf_score_list"],
                                      conf[0][keep[0]])
        assert got["lbl_list"] == [det.cls_list[i] for i in
                                   cls[0][keep[0]].argmax(-1)]
        kept += len(want)
    assert kept > 0


def test_evaluate_batched_matches_jax(scene, pil_only):
    """The path as a whole: ``evaluate_batched`` at 64x64 gives the JAX
    package's mAP vectors within rtol 1e-6 on the same set, weights and
    threshold."""
    det = Detector(scene["model"], conf_thre=scene["thre"])
    jdet = jeval.Detector(scene["jmodel"], scene["jv"],
                          conf_thre=scene["thre"])
    ours = evaluate_batched(det, scene["dataset"], image_hw=HW, batch_size=5)
    ref = jeval.evaluate_batched(jdet, scene["dataset"], image_hw=HW,
                                 batch_size=5)
    np.testing.assert_array_equal(ours["level_list"], ref["level_list"])
    for c in det.cls_list:
        np.testing.assert_allclose(ours[c], ref[c], rtol=1e-6, atol=1e-9,
                                   err_msg=c)
    assert sum(bool(ref[c].any()) for c in det.cls_list) >= 2


def test_detect_with_the_loader_matches_jax(scene):
    """``Detector.detect`` at 375x500, 500x375 and 333x500 with both
    packages resizing through their C++ loaders: labels equal, confidences
    and boxes within the heads' distance (7e-5) carried through the
    sigmoid and exp of decode_v3 and the inverse resize (up to 500 / 64)."""
    assert native_loader.available() and tnative_loader.available()
    det = Detector(scene["model"], conf_thre=scene["thre"])
    jdet = jeval.Detector(scene["jmodel"], scene["jv"],
                          conf_thre=scene["thre"])
    kept = 0
    for _, img, _ in scene["dataset"].items:
        got, ref = det.detect(img), jdet.detect(img)
        assert got["lbl_list"] == ref["lbl_list"]
        kept += len(got["lbl_list"])
        for key in ("conf_score_list", "cls_spec_conf_score_list"):
            np.testing.assert_allclose(got[key], ref[key], rtol=0, atol=2e-5)
        np.testing.assert_allclose(
            np.asarray(got["bbox_list"]).reshape(-1, 4),
            np.asarray(ref["bbox_list"]).reshape(-1, 4), rtol=1e-4, atol=1e-2)
    assert kept > 0


def test_evaluate_batched_with_the_loader_matches_jax(scene):
    """``test_evaluate_batched_matches_jax`` with both C++ loaders on."""
    assert native_loader.available() and tnative_loader.available()
    test_evaluate_batched_matches_jax(scene, None)


def test_v3_evaluation_refusals(scene):
    """The YOLOv2 int8 engine and the native-size evaluator are refused
    for a YOLOv3 (its int8 is the model's ``int8_dynamic``)."""
    for kw in (dict(int8_scales=np.ones((22, 2))), dict(int8_neck=True)):
        with pytest.raises(ValueError, match="YOLOv2-only"):
            Detector(scene["model"], **kw)
    with pytest.raises(ValueError, match="v2-only"):
        evaluate_batched_native(Detector(scene["model"]), scene["dataset"])


# -- the command line --------------------------------------------------------


@pytest.fixture()
def ckpt_root(tmp_path):
    """A checkpoint root emptied after the test, passed or failed: a v3
    train state (model and momentum) is 0.5 GB on disk and pytest keeps
    the temporary folders of its last three runs."""
    root = tmp_path / "ckpts"
    yield root
    for path in root.glob("**/*.ckpt"):
        path.unlink()


def test_cli_trains_yolov3_on_the_cpu(tmp_path, ckpt_root):
    """``python -m odc_tpu_torch.train --model YOLOv3 --image-size 64`` end
    to end in a subprocess (heads 2, 4 and 8; device augmentation) on a
    synthetic VOC of four train and two val images (a full-width train
    step is seconds on the CPU): an epoch, finite losses, the checkpoints
    written."""
    make_synthetic_voc(str(tmp_path / "voc"), num_train=4, num_val=2,
                       image_hw=(96, 128), seed=4)
    stdout = run_python(
        "-m", "odc_tpu_torch.train", "--device", "cpu",
        "--model", "YOLOv3", "--epochs", "1", "--batch-size", "4",
        "--image-size", "64", "--dtype", "float32", "--augment", "device",
        "--dataset-dir", str(tmp_path / "voc"),
        "--ckpt-root", str(ckpt_root),
        timeout=CLI_LIMIT_S,
    ).stdout.decode()
    assert "Epoch: 1 -->" in stdout and "nan" not in stdout.lower()
    (run_dir,) = (ckpt_root / "YOLOv3").iterdir()
    names = {p.name for p in run_dir.iterdir()}
    assert {"final_model.ckpt", "best_model.ckpt", "metrics.jsonl",
            "train_config.json"} <= names
    rows = [json.loads(line)
            for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["kind"] for r in rows] == ["train_epoch", "val_epoch"]
    assert np.isfinite(rows[0]["loss_mean"]) and np.isfinite(rows[1]["loss"])
    config = json.loads((run_dir / "train_config.json").read_text())
    assert config["lambda_xy"] == config["lambda_wh"] == 1.0
