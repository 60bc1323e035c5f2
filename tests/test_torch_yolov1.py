"""The port's YOLOv1 (``odc_tpu_torch.models.yolov1``, ``decode_v1``,
``make_infer_fn``, the v1 train step) against the JAX package on the CPU,
f32, full width at 64x64 (grid 2), weights from jitted flax inits carried
through the bridge with BN calibrated on the images and dropout off on both
sides; plus the dropout contract, which has no JAX counterpart to match
(the two frameworks draw different streams).  ``test_torch_yolov1_eval.py``
holds the forward at 96x96 (grid 3).

GoogLeNet's parameters do not depend on the input size, so one jitted
``GoogLeNetBackbone.init`` (9-14 s to compile here) serves every size, and
each size adds the jitted inits of its two Dense layers
(:func:`jax_v1_init`, which ``test_torch_yolov1_eval.py`` uses too).

BN is calibrated on eight images: at 64x64 the last inception block sees
2 x 2 positions an image, and statistics from two images (8 samples a
channel) leave some channels with a near-zero variance that amplifies the
frameworks' summation-order noise past the forward tolerance (5.3e-3 on
12 of 8192 backbone outputs), where eight images keep it at 2.7e-4."""

import dataclasses
import functools

import numpy as np
import pytest

import flax.linen as fnn
import jax
import jax.numpy as jnp
import torch

from odc_tpu.data.pipeline import Batch as JBatch
from odc_tpu.losses.yolo_loss import Lambdas as JLambdas
from odc_tpu.models.backbones.googlenet import (
    GoogLeNetBackbone as JaxGoogLeNet,
)
from odc_tpu.models.yolov1 import YOLOv1 as JaxYOLOv1
from odc_tpu.ops import decode as jdecode
from odc_tpu.ops.assign import assign_numpy
from odc_tpu.ops.detect import jit_infer_fn
from odc_tpu.train import trainer as jtrainer
from odc_tpu_torch.data.pipeline import Batch
from odc_tpu_torch.data.prefetch import device_prefetch
from odc_tpu_torch.losses.yolo_loss import Lambdas
from odc_tpu_torch.config import MODEL_CONFIG
from odc_tpu_torch.models import MODEL_REGISTRY, get_model, model_from_config
from odc_tpu_torch.models.convert_jax import (
    jax_from_state_dict, jax_from_train_state, load_jax_yolov1,
    state_dict_from_jax, train_state_from_jax,
)
from odc_tpu_torch.models.yolov1 import HIDDEN, YOLOv1, backbone_hw, dropout
from odc_tpu_torch.models.yolov2 import YOLOv2
from odc_tpu_torch.ops import decode as tdecode
from odc_tpu_torch.ops import detect as tdetect
from odc_tpu_torch.ops.cuda.nms_kernel import suppress
from odc_tpu_torch.ops.cuda.superstem_kernel import superstem_plain
from odc_tpu_torch.train import trainer as ttrainer
from torch_port_helpers import calibrate_bn, gap_threshold

# The forward tolerance of test_torch_yolov2 / tests/test_e2e_parity.py.
RTOL, ATOL = 1e-3, 2e-3
CALIB_IMAGES = 8


def v1_kwargs(hw, **kw):
    grid = hw[0] // 32
    return dict(num_grid_cell_in_height=grid, num_grid_cell_in_width=grid,
                image_size=hw, dropout_rate=0.0, **kw)


@functools.lru_cache(maxsize=None)
def _jax_googlenet_init():
    # unsafe_rbg: the init's random draws compile in 9 s, not 13.
    v = jax.jit(JaxGoogLeNet().init)(
        jax.random.key(0, impl="unsafe_rbg"),
        jnp.zeros((1, 64, 64, 3), jnp.uint8))
    return jax.tree.map(np.asarray, v)


@functools.lru_cache(maxsize=None)
def jax_v1_init(hw):
    """(JAX YOLOv1 at ``hw`` with dropout off, its numpy variables): the
    backbone from the one jitted GoogLeNet init, ``Dense_0``/``Dense_1``
    from jitted flax ``Dense`` inits at this size's widths; the tree is
    ``YOLOv1.init``'s."""
    jmodel = JaxYOLOv1(**v1_kwargs(hw))
    fh, fw = backbone_hw(hw)
    k0, k1 = jax.random.split(jax.random.key(1))
    dense0 = jax.jit(fnn.Dense(HIDDEN).init)(
        k0, jnp.zeros((1, fh * fw * 1024), jnp.float32))
    dense1 = jax.jit(fnn.Dense(jmodel.num_grid_cell_in_height
                               * jmodel.num_grid_cell_in_width * 30).init)(
        k1, jnp.zeros((1, HIDDEN), jnp.float32))
    g = _jax_googlenet_init()
    variables = {
        "params": {"GoogLeNetBackbone_0": g["params"],
                   "Dense_0": dense0["params"], "Dense_1": dense1["params"]},
        "batch_stats": {"GoogLeNetBackbone_0": g["batch_stats"]},
    }
    return jmodel, jax.tree.map(np.asarray, variables)


@functools.lru_cache(maxsize=None)
def v1_setup(hw, seed=0):
    """(images [8, *hw, 3] uint8, JAX YOLOv1, numpy variables, the port's
    f32 CPU model in eval mode): :func:`jax_v1_init` bridged into the port,
    BN calibrated on the images."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 255, (CALIB_IMAGES, *hw, 3), dtype=np.uint8)
    jmodel, init = jax_v1_init(hw)
    model = YOLOv1(**v1_kwargs(hw), device="cpu")
    load_jax_yolov1(model, init)
    variables = calibrate_bn(model.eval(), images)
    return images, jmodel, variables, model


@functools.lru_cache(maxsize=None)
def _shared(hw):
    """``v1_setup(hw)`` with the JAX head and backbone outputs of its
    images, from one jitted apply."""
    images, jmodel, variables, model = v1_setup(hw)
    jv = jax.tree.map(jnp.asarray, variables)

    def apply(v, x):
        return jmodel.apply(v, x, capture_intermediates=lambda mdl, _: (
            isinstance(mdl, JaxGoogLeNet)))

    y, inter = jax.jit(apply)(jv, jnp.asarray(images))
    (feat,) = inter["intermediates"]["GoogLeNetBackbone_0"]["__call__"]
    return dict(hw=hw, images=images, jmodel=jmodel, variables=variables,
                jv=jv, model=model, y=np.asarray(y), feat=np.asarray(feat))


@pytest.fixture()
def shared():
    return _shared((64, 64))




# -- the model -----------------------------------------------------------


def test_backbone_matches_jax(shared):
    """GoogLeNet [8, g, g, 1024] against JAX ``GoogLeNetBackbone`` inside
    the same forward, rtol 1e-3 and atol 2e-3."""
    with torch.no_grad():
        got = shared["model"].backbone(torch.tensor(shared["images"])).numpy()
    grid = shared["hw"][0] // 32
    assert got.shape == shared["feat"].shape == (CALIB_IMAGES, grid, grid,
                                                 1024)
    assert shared["feat"].std() > 0.1  # calibrated: O(1) activations
    np.testing.assert_allclose(got, shared["feat"], rtol=RTOL, atol=ATOL)


def test_head_matches_jax(shared):
    """Head [8, g, g, 30] from the same weights, rtol 1e-3 and atol 2e-3."""
    with torch.no_grad():
        got = shared["model"](torch.tensor(shared["images"])).numpy()
    grid = shared["hw"][0] // 32
    assert got.shape == shared["y"].shape == (CALIB_IMAGES, grid, grid, 30)
    assert got.dtype == np.float32
    assert shared["y"].std() > 0.1  # calibrated: not bias-dominated
    np.testing.assert_allclose(got, shared["y"], rtol=RTOL, atol=ATOL)


def test_bridge_round_trips_exactly(shared):
    """flax tree -> state_dict -> flax tree, leaf for leaf; the port's own
    model has exactly the bridged names and shapes (Dense kernels
    transposed); the test's composed flax init has ``YOLOv1.init``'s
    tree."""
    # The composed init has YOLOv1.init's tree (traced, not compiled).
    jmodel, init = jax_v1_init(shared["hw"])
    ref = jax.eval_shape(jmodel.init, jax.random.key(0),
                         jnp.zeros((1, *shared["hw"], 3), jnp.uint8))
    assert jax.tree.structure(ref) == jax.tree.structure(init)
    assert all(r.shape == a.shape and r.dtype == a.dtype for r, a in
               zip(jax.tree.leaves(ref), jax.tree.leaves(init)))
    tree = shared["variables"]
    sd = state_dict_from_jax(tree)
    back = jax_from_state_dict(sd)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    own = shared["model"].state_dict()
    assert sorted(own) == sorted(sd)
    assert all(own[k].shape == sd[k].shape for k in sd)
    dense = tree["params"]["Dense_0"]["kernel"]
    assert sd["fc1.weight"].shape == dense.shape[::-1]
    # Units are numbered by construction: Inception_8 is 5b, not 3a.
    np.testing.assert_array_equal(
        sd["backbone.inception5b.branch4.1.conv.weight"].numpy(),
        tree["params"]["GoogLeNetBackbone_0"]["Inception_8"]["BasicConv2d_5"]
        ["Conv_0"]["kernel"].transpose(3, 2, 0, 1))


@pytest.mark.parametrize("legacy", [False, True])
def test_decode_matches_jax(legacy):
    """``decode_v1`` and ``decode_v1_preactivated`` (the legacy sigmoid
    head's) against the JAX package's at two input sizes: every field
    within rtol 1e-6, box corners also atol 1e-4 px (as ``decode_v2``).
    A model's ``decode`` picks the one its head needs."""
    rng = np.random.default_rng(4)
    y = rng.normal(0, 1.5, (2, 7, 7, 30)).astype(np.float32)
    if legacy:
        y = 1 / (1 + np.exp(-y))
    name = "decode_v1_preactivated" if legacy else "decode_v1"
    for hw in ((224, 224), (96, 128)):
        ref = getattr(jdecode, name)(jnp.asarray(y), hw)
        got = getattr(tdecode, name)(torch.tensor(y), hw)
        for field in tdecode.Detections._fields:
            np.testing.assert_allclose(
                getattr(got, field).numpy(), np.asarray(getattr(ref, field)),
                rtol=1e-6, atol=1e-4 if field == "boxes" else 0,
                err_msg=f"{hw} {field}")
    assert got.cls_prob.shape == (2, 7, 7, 20)
    assert got.cls_spec.shape == (2, 7, 7, 2, 20)
    model = YOLOv1(**v1_kwargs((64, 64), legacy_sigmoid_head=legacy),
                   device="meta")
    small = torch.tensor(y[:, :2, :2])
    want = getattr(tdecode, name)(small, (64, 64))
    for a, b in zip(model.decode(small), want):
        assert torch.equal(a, b)


def test_legacy_sigmoid_head_is_one_sigmoid(shared):
    """The legacy head is the sigmoid of the standard head, same weights."""
    legacy = YOLOv1(**v1_kwargs(shared["hw"], legacy_sigmoid_head=True),
                    device="cpu").eval()
    legacy.load_state_dict(shared["model"].state_dict())
    x = torch.tensor(shared["images"][:2])
    with torch.no_grad():
        np.testing.assert_array_equal(
            legacy(x).numpy(), torch.sigmoid(shared["model"](x)).numpy())


def test_registry():
    model = get_model("YOLOv1", **v1_kwargs((64, 64)), device="cpu")
    assert isinstance(model, YOLOv1) and model.fc2.out_features == 2 * 2 * 30
    assert MODEL_REGISTRY["YOLOv2"].__name__ == "YOLOv2"
    with pytest.raises(KeyError, match="unknown model"):
        get_model("YOLOv9")
    assert MODEL_REGISTRY["YOLOv3"].__name__ == "YOLOv3"


def test_model_from_config():
    """A ``ModelConfig`` builds each model from the fields its class takes
    (the v1 grid and anchors; the v2 and v3 size only), and the model
    carries its mode."""
    cfg = dataclasses.replace(MODEL_CONFIG["YOLOv1"], image_size=(64, 64),
                              num_grid_cell_in_height=2,
                              num_grid_cell_in_width=2)
    v1 = model_from_config(cfg, device="meta")
    assert isinstance(v1, YOLOv1) and v1.mode == "v1"
    assert v1.fc2.out_features == 2 * 2 * 30 and v1.image_size == (64, 64)
    v2 = model_from_config(MODEL_CONFIG["YOLOv2"], device="meta")
    assert isinstance(v2, YOLOv2) and v2.mode == "v2"
    assert v2.num_anchor_box == 5  # the config's v1 anchor count not taken
    v3 = model_from_config(MODEL_CONFIG["YOLOv3"], device="meta")
    assert v3.mode == "v3" and v3.image_size == (416, 416)


# -- dropout -------------------------------------------------------------


def _dropout_model(rate=0.5):
    model = YOLOv1(**{**v1_kwargs((64, 64)), "dropout_rate": rate},
                   device="cpu")
    return model.train()


def test_dropout_draws_from_the_given_generator_only():
    """Same seed, same mask; another seed, another; the global generator
    is neither read nor moved; the kept units are scaled by 1/(1 - rate)."""
    model = _dropout_model()
    x = torch.tensor(np.random.default_rng(1).integers(
        0, 255, (2, 64, 64, 3), dtype=np.uint8))
    state = torch.random.get_rng_state()
    with torch.no_grad():
        a = model(x, generator=torch.Generator().manual_seed(7))
        b = model(x, generator=torch.Generator().manual_seed(7))
        c = model(x, generator=torch.Generator().manual_seed(8))
    assert torch.equal(torch.random.get_rng_state(), state)
    assert torch.equal(a, b) and not torch.equal(a, c)
    h = torch.randn(4, 4096)
    out = dropout(h, 0.25, torch.Generator().manual_seed(0))
    kept = out != 0
    assert 0.6 < kept.float().mean() < 0.9
    torch.testing.assert_close(out[kept], h[kept] / 0.75)


def test_dropout_identity_cases():
    """Rate 0 in training mode and eval mode at rate 0.5 need no generator,
    give what they give with one, and draw nothing from it."""
    x = torch.tensor(np.random.default_rng(2).integers(
        0, 255, (2, 64, 64, 3), dtype=np.uint8))
    for model in (_dropout_model(0.0), _dropout_model(0.5).eval()):
        gen = torch.Generator().manual_seed(3)
        before = gen.get_state()
        with torch.no_grad():
            assert torch.equal(model(x), model(x, generator=gen))
        assert torch.equal(gen.get_state(), before)


def test_training_without_a_generator_raises():
    model = _dropout_model()
    x = torch.zeros(2, 64, 64, 3, dtype=torch.uint8)
    with pytest.raises(ValueError, match="torch.Generator"):
        model(x)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        YOLOv1(dropout_rate=1.0, device="meta")


# -- inference -----------------------------------------------------------


def _gap_conf(y):
    """A threshold in the largest gap of the head's box confidences."""
    conf = 1 / (1 + np.exp(-y[..., 4:10:5].astype(np.float64)))
    return gap_threshold(conf, conf.size // 8, conf.size // 2)


@functools.lru_cache(maxsize=None)
def _jax_infer(class_wise):
    """``jit_infer_fn`` of the 64x64 setup at its gap threshold, numpy."""
    shared = _shared((64, 64))
    fn = jit_infer_fn(shared["jmodel"], conf_thre=_gap_conf(shared["y"]),
                      iou_thre=0.5, max_keep=64, class_wise=class_wise)
    return [np.asarray(a) for a in fn(shared["jv"], shared["images"])]


@pytest.mark.parametrize(
    "compact,class_wise", [(False, False), (True, False), (False, True)])
def test_infer_matches_jit_infer_fn(shared, compact, class_wise, monkeypatch):
    """``make_infer_fn`` on YOLOv1 against the JAX package's, the threshold
    in a gap of the candidates' confidences: keep masks (and labels) equal,
    boxes within 1e-4 of the largest coordinate, confidences and scores
    within 2e-5; the compact outputs against the JAX package's compact
    formula on its full ones.  The superstem is never called (not even its
    plain version) and the NMS wrapper runs its plain version here."""
    images = shared["images"]
    thre = _gap_conf(shared["y"])
    kw = dict(conf_thre=thre, iou_thre=0.5, max_keep=64,
              class_wise=class_wise, compact=compact)
    ref = _jax_infer(class_wise)
    if compact:  # as the JAX package's compact outputs are formed
        ref = [ref[0], ref[1], ref[2].argmax(-1).astype(np.int32),
               ref[2].max(-1), ref[3]]

    def no_superstem(*args, **kwargs):
        raise AssertionError("the superstem ran on a YOLOv1")

    monkeypatch.setattr(tdetect, "superstem", no_superstem)
    launches = suppress.launches
    got = [t.numpy() for t in
           tdetect.make_infer_fn(shared["model"], **kw)(torch.tensor(images))]
    assert suppress.launches == launches  # CPU: the plain version
    keep = ref[-1]
    assert 0 < keep.sum() < keep.size
    np.testing.assert_array_equal(got[-1], keep)
    np.testing.assert_allclose(got[0], ref[0], rtol=0,
                               atol=1e-4 * np.abs(ref[0]).max())
    for r, g in zip(ref[1:-1], got[1:-1]):
        if r.dtype == np.int32:
            np.testing.assert_array_equal(g, r)
        else:
            np.testing.assert_allclose(g, r, rtol=0, atol=2e-5)
    assert got[0].shape == (CALIB_IMAGES, 64, 4)
    if compact:
        assert len(got) == 5 and got[2].dtype == np.int32


class _RenamedYOLOv2(YOLOv2):
    """A YOLOv2 under another class name: still a Darknet-19 backbone."""


@pytest.mark.parametrize("cls,stems", [
    (YOLOv1, 0), (YOLOv2, 1), (_RenamedYOLOv2, 1)])
def test_superstem_follows_the_backbone(cls, stems, monkeypatch):
    """``make_infer_fn`` runs the fused superstem once a call for a model on
    a Darknet-19 backbone, whatever its class is named, and never for a
    YOLOv1 (GoogLeNet)."""
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return superstem_plain(*args, **kwargs)

    monkeypatch.setattr(tdetect, "superstem", counted)
    kw = v1_kwargs((64, 64)) if cls is YOLOv1 else dict(image_size=(64, 64))
    model = cls(**kw, device="cpu")
    images = torch.tensor(np.random.default_rng(4).integers(
        0, 255, (2, 64, 64, 3), dtype=np.uint8))
    out = tdetect.make_infer_fn(model, conf_thre=0.0)(images)
    assert len(calls) == stems and out[0].shape == (2, 64, 4)


def test_infer_refuses_int8_on_yolov1():
    model = YOLOv1(**v1_kwargs((64, 64)), device="cpu")
    for kw in (dict(int8_neck=True), dict(int8_scales=np.ones((22, 2)))):
        with pytest.raises(ValueError, match="require a YOLOv2"):
            tdetect.make_infer_fn(model, **kw)


# -- one train step ------------------------------------------------------

MOMENTUM, WD = 0.9, 5e-4
METRICS = ("loss", "loss_xy", "loss_wh", "loss_conf", "loss_noobj", "loss_cls")


def _v1_batch(hw, seed, b=4, m=8):
    """A batch [b, *hw, 3] with 1-3 boxes an image, ``Batch`` field order,
    targets from ``assign_numpy(mode="v1")``."""
    rng = np.random.default_rng(seed)
    h, w = hw
    image = rng.integers(0, 255, (b, h, w, 3), dtype=np.uint8)
    rows = []
    for _ in range(b):
        n = int(rng.integers(1, 4))
        x1 = rng.uniform(0, w - 24, n)
        y1 = rng.uniform(0, h - 24, n)
        boxes = np.stack([x1, y1, x1 + rng.uniform(8, 23, n),
                          y1 + rng.uniform(8, 23, n)], -1)
        rows.append(assign_numpy(boxes, rng.integers(0, 20, n), hw,
                                 mode="v1", max_boxes=m))
    fields = [np.stack([r[i] for r in rows]) for i in range(6)]
    return (image, *fields, np.arange(b, dtype=np.int32))


def _rel_l2(got, ref):
    got, ref = jax.tree.leaves(got), jax.tree.leaves(ref)
    num = sum(float(np.sum((np.asarray(g, np.float64) - r) ** 2))
              for g, r in zip(got, ref))
    den = sum(float(np.sum(np.asarray(r, np.float64) ** 2)) for r in ref)
    return (num / den) ** 0.5


def _worst_update(ttree, jtree, init):
    """The largest, over parameter leaves, of ||dt - dj|| / ||dj||, with
    dt and dj the port's and JAX's updates (after - before, float64)."""
    worst = 0.0
    for t, j, i in zip(jax.tree.leaves(ttree), jax.tree.leaves(jtree),
                       jax.tree.leaves(init)):
        i = np.asarray(i, np.float64)
        dj = np.asarray(j, np.float64) - i
        dt = np.asarray(t, np.float64) - i
        worst = max(worst, float(np.linalg.norm(dt - dj)
                                 / np.linalg.norm(dj)))
    return worst


def test_one_train_step_matches_jax():
    """One v1 step (momentum 0.9, weight decay 5e-4, dropout off) from a
    bridged init at 64x64: the loss and its five parts within rtol 1e-4
    (the first-step tolerance recorded for v2), the updated parameters
    within 1e-5 relative l2, the BN running statistics within 1e-5; the
    update itself, leaf by leaf, within 5e-2 relative l2 of JAX's (the
    worst leaf measures 2.2e-2: f32 summation order, amplified by the
    random network; one leaf's gradient zeroed gives 1.0); the train state
    crosses the bridge back leaf for leaf."""
    hw = (64, 64)
    _, jmodel, variables, _ = v1_setup(hw)
    arrays = _v1_batch(hw, 5)
    lr = 1e-4
    jstep = jtrainer.make_train_step(
        jmodel, "v1", JLambdas(), None, momentum=MOMENTUM, weight_decay=WD)
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

    state = ttrainer.TrainState(YOLOv1(**v1_kwargs(hw), device="cpu"))
    state.load_state_dict(train_state_from_jax(init))
    tstep = ttrainer.make_train_step(
        "v1", Lambdas(), None, momentum=MOMENTUM, weight_decay=WD)
    batch = next(device_prefetch([Batch(*arrays)], "cpu"))
    state, tm = tstep(state, batch, lr, torch.Generator().manual_seed(0))
    ttree = jax_from_train_state(state.state_dict())

    for name in METRICS:
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=1e-4, err_msg=name)
    assert float(tm["loss_cls"]) > 0 and float(tm["loss_wh"]) > 0
    assert int(ttree["step"]) == int(jtree["step"]) == 1
    assert _rel_l2(ttree["params"], jtree["params"]) < 1e-5
    assert _worst_update(ttree["params"], jtree["params"],
                         init["params"]) < 5e-2
    assert _rel_l2(ttree["batch_stats"], jtree["batch_stats"]) < 1e-5
    # The Dense head sits downstream of every ReLU: its update direction
    # agrees tightly.
    for name in ("Dense_0", "Dense_1"):
        assert _rel_l2(ttree["momentum"][name], jtree["momentum"][name]) < 1e-3
    back = train_state_from_jax(jtree)
    again = jax_from_train_state(back)
    assert jax.tree.structure(again) == jax.tree.structure(jtree)
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(again)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
