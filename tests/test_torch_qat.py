"""The port's QAT (``odc_tpu_torch/ops/qat.py``,
``odc_tpu_torch/train/qat.py``) against ``odc_tpu.ops.qat`` and
``odc_tpu.train.qat`` on the CPU, f32: the fake-quant functions and the
STE bit for bit, the float twin against the port's int8 engine (the JAX
test's own criteria) and against JAX's twin, exact mode against the
engine, one QAT step against JAX's, the fine-tune driver, and the
deliverable (a short QAT lowers the deployed engine's loss).

Two networks: ``int8_parity_setup``'s YOLOv2 with BN calibrated on the
images (2 x 64 x 96), whose random weights amplify every flipped code from
layer to layer, and the port's plain seeded init (BN at identity), on which
the twins of the two frameworks agree closely enough to hold gradients.
Between frameworks the f32 convolutions sum in another order, which flips
fake-quant codes (1e-5 of them after two layers, 2-3 % after ten); a flip
moves a max pool's winner or a LeakyReLU's side, so gradients agree to a
few percent, not bitwise.  The JAX twin runs under ``jit`` (its eager run
gives the same gradients within 2e-6)."""

import copy
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from odc_tpu.data.pipeline import Batch as JBatch
from odc_tpu.losses.yolo_loss import Lambdas as JLambdas
from odc_tpu.ops import qat as jq
from odc_tpu.ops.assign import assign_numpy
from odc_tpu.train import trainer as jtrainer
from odc_tpu_torch.data.pipeline import Batch, DetectionPipeline
from odc_tpu_torch.data.prefetch import device_prefetch
from odc_tpu_torch.data.voc import VOC, make_synthetic_voc
from odc_tpu_torch.losses.yolo_loss import Lambdas
from odc_tpu_torch.models.convert_jax import (
    jax_from_state_dict, jax_from_train_state, params_from_jax,
    train_state_from_jax,
)
from odc_tpu_torch.models.yolov1 import YOLOv1
from odc_tpu_torch.models.yolov2 import YOLOv2
from odc_tpu_torch.ops import int8_engine as te
from odc_tpu_torch.ops import qat as tq
from odc_tpu_torch.ops.detect import make_infer_fn
from odc_tpu_torch.train import checkpoint
from odc_tpu_torch.train import qat as tqat
from odc_tpu_torch.train.trainer import TrainState
from torch_port_helpers import int8_parity_setup, port_model

METRICS = ("loss", "loss_xy", "loss_wh", "loss_conf", "loss_noobj", "loss_cls")


@functools.lru_cache(maxsize=None)
def _network(kind: str):
    """(port model, JAX variables, images, scales) of the calibrated
    (``"calibrated"``) or plain-init (``"plain"``) YOLOv2; scales from the
    port's ``calibrate`` on the images."""
    images, _, variables = int8_parity_setup()
    if kind == "plain":
        model = YOLOv2(dtype=torch.float32, device="cpu", seed=0).eval()
        variables = jax_from_state_dict(model.state_dict())
    else:
        model = port_model(variables)
    scales = te.calibrate(model, torch.tensor(images))
    return model, variables, images, scales


@functools.lru_cache(maxsize=None)
def _calibrated_heads(stem: str):
    """(engine head, twin head) of the calibrated network for ``stem``,
    computed once for the tests that read them."""
    model, _, images, scales = _network("calibrated")
    x = torch.tensor(images)
    with torch.no_grad():
        return (te.yolov2_int8_forward(model, x, scales=scales, stem=stem),
                tq.yolov2_qat_forward(model, x, scales, stem=stem))


@functools.partial(jax.jit, static_argnums=3)
def _jax_twin(variables, images, scales, stem):
    return jq.yolov2_qat_forward(variables, images, scales, stem=stem)


@functools.partial(jax.jit, static_argnums=4)
def _jax_twin_grad(params, batch_stats, images, scales, stem, w):
    def loss(p):
        y = jq.yolov2_qat_forward({"params": p, "batch_stats": batch_stats},
                                  images, scales, stem=stem)
        return jnp.sum(y * w)

    return jax.grad(loss)(params)


def _rel(got, ref) -> float:
    d = np.subtract(got, ref, dtype=np.float64).ravel()
    return float(np.linalg.norm(d)
                 / np.linalg.norm(np.asarray(ref, np.float64)))


# -- fake quantization and the STE, bit for bit ------------------------------


def _weight_cases():
    """HWIO kernels: channel 0 has amax 127 (scale exactly 1) and exact
    .5 ties plus both clip edges, channel 1 is all zero (the eps floor),
    channel 2 is tiny, the rest are random."""
    rng = np.random.default_rng(0)
    k = rng.normal(size=(3, 3, 4, 8)).astype(np.float32)
    ties = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -126.5, 127.0, -127.0,
                     3.5, -3.5, 0.0], np.float32)
    k[..., 0] = np.resize(ties, (3, 3, 4))
    k[..., 1] = 0.0
    k[..., 2] *= 1e-9
    return k


def test_fake_quant_weight_matches_jax():
    """Values bitwise (half-to-even ties at scale 1, the ±127 clip, an all-
    zero channel at the eps floor); the gradient is the STE's identity in
    both."""
    k = _weight_cases()
    w = np.random.default_rng(1).normal(size=k.shape).astype(np.float32)
    ref = np.asarray(jq.fake_quant_weight(jnp.asarray(k)))
    kt = torch.tensor(k, requires_grad=True)
    got = tq.fake_quant_weight(kt)
    np.testing.assert_array_equal(got.detach().numpy(), ref)
    assert ref[0, 0, 0, 0] == 0.0 and ref[0, 0, 2, 0] == 2.0  # 0.5, 2.5
    jgrad = np.asarray(jax.grad(
        lambda x: jnp.sum(jq.fake_quant_weight(x) * w))(jnp.asarray(k)))
    (got * torch.tensor(w)).sum().backward()
    np.testing.assert_array_equal(kt.grad.numpy(), jgrad)
    np.testing.assert_array_equal(jgrad, w)


@pytest.mark.parametrize("row", [(127.0, 128.0), (3.7, 0.9), (0.02, 1e-7)])
def test_fake_quant_act_matches_jax(row):
    """One calibrated row each: (127, 128) gives scale 1 and zero point 0,
    so the .5 values are exact ties and ±300 clip at 127 / -128; the other
    rows are calibrated-like.  Values and gradients bitwise."""
    rng = np.random.default_rng(2)
    s = (row[0] + row[1]) / 255.0
    y = np.concatenate([
        np.array([0.5, 1.5, 2.5, -0.5, -1.5, 126.5, -127.5, 127.4, 300.0,
                  -300.0], np.float32) * np.float32(s),
        rng.uniform(-1.5 * row[1], 1.5 * row[0], 500).astype(np.float32),
    ])
    stat = np.asarray(row, np.float32)
    w = rng.normal(size=y.shape).astype(np.float32)
    ref = np.asarray(jq.fake_quant_act(jnp.asarray(y), jnp.asarray(stat)))
    yt = torch.tensor(y, requires_grad=True)
    got = tq.fake_quant_act(yt, torch.tensor(stat))
    np.testing.assert_array_equal(got.detach().numpy(), ref)
    jgrad = np.asarray(jax.grad(lambda x: jnp.sum(
        jq.fake_quant_act(x, jnp.asarray(stat)) * w))(jnp.asarray(y)))
    (got * torch.tensor(w)).sum().backward()
    np.testing.assert_array_equal(yt.grad.numpy(), jgrad)


def test_fake_quant_input_matches_jax():
    """The plain stem's static symmetric input quantization: ImageNet-
    normalized pixels and values past the ±2.7 clip, bitwise."""
    rng = np.random.default_rng(3)
    h0 = np.concatenate([rng.uniform(-2.2, 2.7, 1000),
                         [2.7, -2.7, 3.5, -4.0, 0.0]]).astype(np.float32)
    ref = np.asarray(jq._fake_quant_input(jnp.asarray(h0)))
    np.testing.assert_array_equal(
        tq._fake_quant_input(torch.tensor(h0)).numpy(), ref)


def test_ste_value_matches_jax():
    """``x + (q - x).detach()`` is JAX's ``x + stop_gradient(q - x)`` bit
    for bit, and differs from ``q`` itself where ``q - x`` rounds (``q`` far
    below ``x`` in magnitude): writing ``q`` with a custom gradient would
    not match."""
    rng = np.random.default_rng(4)
    x = (rng.normal(size=4096) * 10).astype(np.float32)
    q = (np.round(x * 7) / 7).astype(np.float32)
    x[:4] = [1.0, -3.0, 1e4, 0.5]
    q[:4] = [3e-8, 1e-9, 1e-4, -1e-9]
    ref = np.asarray(jq._ste(jnp.asarray(x), jnp.asarray(q)))
    got = tq._ste(torch.tensor(x), torch.tensor(q)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert np.any(got != q)


# -- guards ------------------------------------------------------------


@pytest.mark.parametrize("scales, stem, match", [
    (np.zeros((5, 2), np.float32), "s2d", "scales"),
    (np.ones((22, 2), np.float32), "s2d2", "stem"),
])
def test_qat_forward_guards(scales, stem, match):
    model, _, images, _ = _network("calibrated")
    with pytest.raises(ValueError, match=match):
        tq.yolov2_qat_forward(model, torch.tensor(images), scales, stem=stem)


@pytest.mark.parametrize("make", [
    lambda: YOLOv2(neck="space_to_depth", device="cpu"),
    lambda: YOLOv1(num_grid_cell_in_height=2, num_grid_cell_in_width=2,
                   image_size=(64, 64), device="cpu"),
], ids=["space_to_depth", "YOLOv1"])
def test_qat_rejects_non_engine_model(make):
    with pytest.raises(ValueError, match="quadrant"):
        tq.make_qat_train_step(make(), Lambdas(), np.ones((22, 2), np.float32))


# -- the twin --------------------------------------------------------------


@pytest.mark.parametrize("stem", ["plain", "s2d"])
def test_twin_matches_engine(stem):
    """``tests/test_qat.py``'s criteria on the port: the twin sits at the
    engine's distance from the f32 model (max within 1.5x) and much closer
    to the engine than the engine is to the f32 model (mean within 0.75x).
    Measured: s2d max 0.564 against 0.845, mean 0.0046 against 0.0918;
    plain 0.656 against 0.938, mean 0.0400 against 0.1006."""
    model, _, images, scales = _network("calibrated")
    with torch.no_grad():
        ref = model(torch.tensor(images)).numpy()
    eng, qat = (y.numpy() for y in _calibrated_heads(stem))
    err_eng = np.abs(eng - ref)
    assert np.abs(qat - ref).max() <= 1.5 * err_eng.max() + 1e-4
    d = np.abs(qat - eng)
    assert d.mean() <= 0.75 * err_eng.mean() + 1e-6, (d.mean(), err_eng.mean())


@pytest.mark.parametrize("stem", ["plain", "s2d"])
def test_twin_head_and_gradients_match_jax(stem):
    """The port's twin against JAX's under ``jit``, relative l2.

    Calibrated network, head within 0.15 (measured 0.056 s2d, 0.075 plain;
    JAX's own jitted and eager twins differ by 0.028 and 0.072 there).
    Plain init, head within 2e-3 (measured 4.2e-4); gradients of a loss
    linear in the head within 0.06 over all parameters (measured 0.026 s2d,
    0.024 plain) and 0.3 in the worst leaf (0.204 and 0.144, conv0's
    weight; 0.14-0.22 over three loss weightings).  Planted faults the
    leaf check catches: an ``amax`` pool, which splits the gradient between
    tied maxima where XLA gives it to the first (0.34-0.39), the s2d stem
    without its bf16 roundings (0.44), no STE (1.0)."""
    _, variables, images, scales = _network("calibrated")
    got = _calibrated_heads(stem)[1].numpy()
    ref = _jax_twin(variables, images, scales.numpy(), stem)
    assert _rel(got, ref) < 0.15

    model, variables, images, scales = _network("plain")
    x = torch.tensor(images)
    y = tq.yolov2_qat_forward(model, x, scales, stem=stem)
    ref = _jax_twin(variables, images, scales.numpy(), stem)
    assert _rel(y.detach().numpy(), ref) < 2e-3

    w = np.random.default_rng(5).normal(size=y.shape).astype(np.float32)
    model.zero_grad(set_to_none=True)
    (y * torch.tensor(w)).sum().backward()
    got = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    jg = _jax_twin_grad(variables["params"], variables["batch_stats"],
                        images, scales.numpy(), stem, w)
    ref = {n: t.numpy() for n, t in
           params_from_jax(jax.tree.map(np.asarray, jg)).items()}
    assert _rel(np.concatenate([got[n].ravel() for n in ref]),
                np.concatenate([ref[n].ravel() for n in ref])) < 0.06
    worst = max(_rel(got[n], ref[n]) for n in ref)
    assert worst < 0.3, worst


@pytest.mark.parametrize("stem", ["plain", "s2d"])
def test_exact_mode_is_the_engine(stem):
    """``exact=True``: the value is the port's engine bit for bit (and the
    engine is the eager JAX engine's, ``tests/test_torch_int8_engine.py``);
    with a loss linear in the head its gradients are the twin's bit for
    bit (the cotangent passes straight to the twin).  Under a squared loss
    (the QAT steps below) they are finite and move the engine's loss."""
    model, _, images, scales = _network("calibrated")
    x = torch.tensor(images)
    eng = _calibrated_heads(stem)[0]
    w = torch.tensor(np.random.default_rng(6).normal(
        size=eng.shape).astype(np.float32))

    def grads(exact, loss):
        model.zero_grad(set_to_none=True)
        y = tq.yolov2_qat_forward(model, x, scales, stem=stem, exact=exact)
        loss(y).backward()
        g = {n: p.grad.clone() for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return y.detach(), g

    y, g_exact = grads(True, lambda y: (y * w).sum())
    assert torch.equal(y, eng)
    _, g_twin = grads(False, lambda y: (y * w).sum())
    assert all(torch.equal(g_exact[n], g_twin[n]) for n in g_twin)
    assert any(bool((g != 0).any()) for g in g_twin.values())


# -- the step and the driver ----------------------------------------------


def _batch(images, seed=7, m=4):
    """The images with 1-3 boxes each, as numpy arrays in ``Batch`` order
    (targets from ``assign_numpy``)."""
    rng = np.random.default_rng(seed)
    b, h, w = images.shape[:3]
    rows = []
    for _ in range(b):
        n = int(rng.integers(1, 4))
        x1 = rng.uniform(0, w - 34, n)
        y1 = rng.uniform(0, h - 34, n)
        bl = np.stack([x1, y1, x1 + rng.uniform(10, 33, n),
                       y1 + rng.uniform(10, 33, n)], -1)
        rows.append(assign_numpy(bl, rng.integers(0, 20, n), (h, w),
                                 mode="v2", max_boxes=m))
    fields = [np.stack([r[i] for r in rows]) for i in range(6)]
    return (images, *fields, np.arange(b, dtype=np.int32))


def test_qat_step_matches_jax():
    """One ``make_qat_train_step(exact=False)`` step (momentum 0.9, weight
    decay 5e-4) against JAX's from the bridged plain init: the loss and its
    parts within rtol 1e-4; the update (after - before) within 5e-2
    relative l2 over all parameters (measured 1.2e-2) and 0.3 in the worst
    leaf (measured 0.186, an early backbone leaf: the twin's gradients
    carry the cross-framework code flips, ``test_twin_head_and_gradients_
    match_jax``; the 5e-2 a leaf of the batch-statistics train steps does
    not hold here); every parameter given a gradient; BN running statistics
    bitwise unchanged in both."""
    model, variables, images, scales = _network("plain")
    model = copy.deepcopy(model)
    arrays = _batch(images)
    lr = 1e-4
    jmodel = int8_parity_setup()[1]
    jstep = jq.make_qat_train_step(
        jmodel, JLambdas(), jnp.asarray(scales.numpy()), momentum=0.9,
        weight_decay=5e-4, exact=False)
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

    state = TrainState(model)
    state.load_state_dict(train_state_from_jax(init))
    step = tq.make_qat_train_step(model, Lambdas(), scales, momentum=0.9,
                                  weight_decay=5e-4, exact=False)
    batch = next(device_prefetch([Batch(*arrays)], "cpu"))
    state, tm = step(state, batch, lr)
    assert all(p.grad is not None for p in model.parameters())
    ttree = jax_from_train_state(state.state_dict())

    for name in METRICS:
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=1e-4, err_msg=name)
    assert int(ttree["step"]) == int(jtree["step"]) == 1
    dt, dj = [], []
    for t, j, i in zip(jax.tree.leaves(ttree["params"]),
                       jax.tree.leaves(jtree["params"]),
                       jax.tree.leaves(init["params"])):
        dt.append(np.subtract(t, i, dtype=np.float64).ravel())
        dj.append(np.subtract(j, i, dtype=np.float64).ravel())
    assert _rel(np.concatenate(dt), np.concatenate(dj)) < 5e-2
    worst = max(_rel(t, j) for t, j in zip(dt, dj))
    assert worst < 0.3, worst
    for tree in (ttree, jtree):
        for a, b in zip(jax.tree.leaves(tree["batch_stats"]),
                        jax.tree.leaves(init["batch_stats"])):
            np.testing.assert_array_equal(a, b)


def _state_tensors(state):
    sd = state.state_dict()
    out = {f"model.{k}": v.clone() for k, v in sd["model"].items()}
    out.update({f"momentum.{k}": v.clone() for k, v in sd["momentum"].items()})
    return out


@pytest.fixture
def qat_dir(tmp_path):
    """A folder for the fine-tune's output; its checkpoints (0.5 GB each)
    are removed afterwards, passed or failed."""
    path = tmp_path / "qat_ckpt"
    yield path
    for ckpt in path.glob("*.ckpt"):
        ckpt.unlink()


def test_finetune_qat_driver(tmp_path, qat_dir):
    """``tests/test_qat.py::test_finetune_qat_driver`` on the port at 96x96:
    pipeline calibration, two exact-mode epochs, the four artifacts, the
    shipped scales equal to the frozen ones, BN statistics bitwise frozen,
    best and final checkpoints restoring the state; then the tuned state
    and ``int8_scales.npy`` serve through ``make_infer_fn(int8_scales=...)``
    and give the engine's boxes.  One train batch an epoch (four images)."""
    import json

    root = str(tmp_path / "voc")
    make_synthetic_voc(root, num_train=4, num_val=4, image_hw=(96, 96))
    voc = VOC(dataset_dir=root)
    hw = (96, 96)
    train_pipe = DetectionPipeline(
        voc.train_dataset, image_hw=hw, batch_size=4, max_boxes=4,
        mode="v2", prefetch=0)
    val_pipe = DetectionPipeline(
        voc.val_dataset, image_hw=hw, batch_size=4, max_boxes=4,
        mode="v2", shuffle=False, drop_remainder=False, prefetch=0)

    model = YOLOv2(dtype=torch.float32, device="cpu", seed=0)
    scales = tqat.calibrate_from_pipeline(model, train_pipe, num_batches=1)
    assert tuple(scales.shape) == (22, 2)

    state = TrainState(model)
    bn_before = {k: v.clone() for k, v in model.state_dict().items()
                 if "running" in k}
    state, hist = tqat.finetune_qat(
        model, state, train_pipe, val_pipe, scales, ckpt_path=str(qat_dir),
        epochs=2, lr=1e-4)
    assert {p.name for p in qat_dir.iterdir()} == {
        "best_qat_model.ckpt", "final_qat_model.ckpt", "int8_scales.npy",
        "metrics.jsonl"}
    assert len(hist["train_loss_mean_list"]) == len(hist["val_loss_list"]) == 2
    assert all(np.isfinite(v) for v in hist["val_loss_list"])
    rows = [json.loads(line) for line in
            (qat_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["kind"] for r in rows] == ["qat_epoch", "qat_val_epoch"] * 2
    assert set(rows[0]) >= {"epoch", "loss_mean", "lr", "images_per_sec"}
    shipped = np.load(qat_dir / "int8_scales.npy")
    np.testing.assert_array_equal(shipped, scales.numpy())
    for k, v in bn_before.items():
        assert torch.equal(model.state_dict()[k], v), k
    assert state.step == 2

    best = checkpoint.restore(str(qat_dir / "best_qat_model.ckpt"),
                              TrainState(YOLOv2(device="cpu", seed=1)))
    assert best.step in (1, 2)
    served = YOLOv2(dtype=torch.float32, device="cpu", seed=2)
    final = checkpoint.restore(str(qat_dir / "final_qat_model.ckpt"),
                               TrainState(served))
    after, restored = _state_tensors(state), _state_tensors(final)
    assert final.step == state.step
    assert all(torch.equal(after[k], restored[k]) for k in after)
    images = torch.tensor(np.random.default_rng(8).integers(
        0, 255, (2, 96, 96, 3), dtype=np.uint8))
    boxes, conf, _, keep = make_infer_fn(served, 0.0, 0.5, 16,
                                         int8_scales=shipped)(images)
    assert boxes.shape == (2, 16, 4) and bool(keep.any())
    with torch.no_grad():
        det = served.decode(te.yolov2_int8_forward(
            served, images, scales=shipped, stem="s2d"), hw)
    top = det.conf.reshape(2, -1).max(1).values
    np.testing.assert_array_equal(conf[:, 0].numpy(), top.numpy())


def test_qat_finetune_reduces_engine_loss():
    """The deliverable (``tests/test_qat.py``'s, mirrored on the plain init
    as JAX's runs on flax's): 4 exact-mode QAT steps (lr 1e-3, momentum
    0.9, no weight decay) on two images with two boxes each lower the loss
    of the DEPLOYED engine under the same frozen scales (measured 1.756 ->
    1.749; it falls at every step, 1.714 after 12, the JAX test's count);
    BN statistics stay bitwise frozen.  (The calibrated network diverges at
    lr 1e-3: its loss reaches 990 by step 4.)"""
    from odc_tpu_torch.ops.assign import assign
    from odc_tpu_torch.train.qat import make_engine_eval_step

    model, _, images, scales = _network("plain")
    model = copy.deepcopy(model)
    x = torch.tensor(images)
    boxes = torch.tensor([[[10.0, 12.0, 60.0, 70.0],
                           [40.0, 30.0, 90.0, 60.0]]] * 2)
    cls = torch.tensor([[3, 7]] * 2, dtype=torch.int32)
    valid = torch.ones(2, 2, dtype=torch.bool)
    t = assign(boxes, cls, valid, tuple(x.shape[1:3]), mode="v2")
    batch = Batch(image=x, cell=t.cell, sig_txty=t.sig_txty, twth=t.twth,
                  box=t.box, cls=t.cls, valid=t.valid,
                  img_id=torch.arange(2, dtype=torch.int32))
    engine_loss = make_engine_eval_step(model, Lambdas(), scales)
    state = TrainState(model)
    bn_before = {k: v.clone() for k, v in model.state_dict().items()
                 if "running" in k}
    l0 = float(engine_loss(state, batch))
    step = tq.make_qat_train_step(model, Lambdas(), scales, momentum=0.9,
                                  weight_decay=0.0)
    for _ in range(4):
        state, metrics = step(state, batch, 1e-3)
    assert np.isfinite(float(metrics["loss"]))
    assert all(bool(torch.isfinite(p.grad).all()) for p in model.parameters())
    l1 = float(engine_loss(state, batch))
    assert l1 < l0, (l0, l1)
    for k, v in bn_before.items():
        assert torch.equal(model.state_dict()[k], v), k
