"""The port's training path (``odc_tpu_torch.train`` and the training mode of
``TorchBatchNorm``) against the JAX package on the CPU, f32, full width at
96x96: BatchNorm, the schedule, train steps from one bridged init (with and
without device augmentation), eval steps, the state bridge, and the epoch loop
(``Trainer.fit``, checkpoints, the command line)."""

import copy
import json
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from odc_tpu.data.pipeline import Batch as JBatch
from odc_tpu.losses.yolo_loss import Lambdas as JLambdas
from odc_tpu.models import layers as jlayers
from odc_tpu.models.yolov2 import YOLOv2 as JaxYOLOv2
from odc_tpu.ops import augment as jaug
from odc_tpu.ops.assign import assign_numpy
from odc_tpu.train import schedule as jschedule
from odc_tpu.train import trainer as jtrainer
from odc_tpu_torch import eval as teval
from odc_tpu_torch.config import TrainConfig
from odc_tpu_torch.data.pipeline import Batch, DetectionPipeline
from odc_tpu_torch.data.prefetch import device_prefetch
from odc_tpu_torch.data.voc import VOC, VOCDataset, make_synthetic_voc
from odc_tpu_torch.losses.yolo_loss import Lambdas
from odc_tpu_torch.models import layers as tlayers
from odc_tpu_torch.models.convert_jax import (
    jax_from_train_state, train_state_from_jax,
)
from odc_tpu_torch.models.yolov2 import YOLOv2
from odc_tpu_torch.ops import augment as taug
from odc_tpu_torch.train import __main__ as cli
from odc_tpu_torch.train import checkpoint
from odc_tpu_torch.train import schedule as tschedule
from odc_tpu_torch.train import trainer as ttrainer
from torch_port_helpers import fresh_yolov2, replay_params, run_python

HW = (96, 96)
B, M = 4, 8
STEPS = 3
MOMENTUM, WD = 0.9, 5e-4
# 3x each CLI child's time in a full tier-1 run, 11.7, 7.7 and 13.5 s
# (CHANGES.md).
V2_CLI_LIMIT_S, V1_CLI_LIMIT_S, QAT_CLI_LIMIT_S = 35, 23, 40


# -- BatchNorm and schedule -------------------------------------------------


@pytest.mark.parametrize(
    "shape",
    [(1, 2, 2, 8),    # n = 4: the n/(n-1) factor is 4/3
     (4, 3, 3, 16),
     (2, 5, 16)],
)
def test_batchnorm_training_matches_flax(shape):
    """Output (biased batch variance) and both running statistics (decay
    0.9, UNBIASED variance) against the flax module, rtol 1e-5."""
    rng = np.random.default_rng(0)
    feat = shape[-1]
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    variables = {
        "params": {"scale": rng.uniform(0.5, 1.5, feat).astype(np.float32),
                   "bias": rng.normal(size=feat).astype(np.float32)},
        "batch_stats": {"mean": rng.normal(size=feat).astype(np.float32),
                        "var": rng.uniform(0.5, 2, feat).astype(np.float32)},
    }
    ref, mut = jlayers.TorchBatchNorm(use_running_average=False).apply(
        variables, jnp.asarray(x), mutable=["batch_stats"]
    )
    bn = tlayers.TorchBatchNorm(feat)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor(variables["params"]["scale"]))
        bn.bias.copy_(torch.tensor(variables["params"]["bias"]))
        bn.running_mean.copy_(torch.tensor(variables["batch_stats"]["mean"]))
        bn.running_var.copy_(torch.tensor(variables["batch_stats"]["var"]))
    bn.train()
    out = bn(torch.tensor(x))
    np.testing.assert_allclose(
        out.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5
    )
    np.testing.assert_allclose(
        bn.running_mean.numpy(), np.asarray(mut["batch_stats"]["mean"]),
        rtol=1e-5, atol=1e-6,
    )
    np.testing.assert_allclose(
        bn.running_var.numpy(), np.asarray(mut["batch_stats"]["var"]),
        rtol=1e-5,
    )
    # The running variance really took the unbiased estimate.
    n = x.size // feat
    unbiased = 0.9 * variables["batch_stats"]["var"] + 0.1 * x.reshape(
        -1, feat).var(0, ddof=1)
    np.testing.assert_allclose(bn.running_var.numpy(), unbiased, rtol=1e-4)
    assert n / (n - 1) > 1.005
    # Eval mode: running statistics normalise and do not move.
    bn.eval()
    frozen = bn.running_var.clone()
    ref_eval = jlayers.TorchBatchNorm(use_running_average=True).apply(
        {"params": variables["params"], "batch_stats": mut["batch_stats"]},
        jnp.asarray(x),
    )
    np.testing.assert_allclose(
        bn(torch.tensor(x)).detach().numpy(), np.asarray(ref_eval),
        rtol=1e-5, atol=1e-5,
    )
    assert torch.equal(bn.running_var, frozen)


@pytest.mark.parametrize(
    "lrs, epochs, warmup",
    [([1e-3, 1e-4, 1e-5], [60, 30, 70], True), ([1e-2], [3], False),
     ([0.1, 0.01], [1, 2], True)],
)
def test_schedule_equal_to_jax(lrs, epochs, warmup):
    ours = tschedule.StagedSchedule(lrs, epochs, warmup)
    theirs = jschedule.StagedSchedule(lrs, epochs, warmup)
    assert ours.total_epochs == theirs.total_epochs
    assert ours.epochs() == theirs.epochs()
    for epoch in (1, 2, epochs[0], epochs[0] + 1, sum(epochs), sum(epochs) + 5):
        assert ours.stage_lr(epoch) == theirs.stage_lr(epoch)
        for progress in (0.01, 0.25, 0.5, 1.0):
            assert ours.step_lr(epoch, progress) == theirs.step_lr(epoch, progress)
    with pytest.raises(ValueError):
        tschedule.StagedSchedule([1e-3], [1, 2])


def test_sgd_update_is_torch_sgd():
    """``sgd_update`` against ``torch.optim.SGD`` (one group, dampening 0)
    with the learning rate set per step."""
    torch.manual_seed(0)
    ours = torch.nn.Sequential(torch.nn.Linear(5, 7), torch.nn.Linear(7, 2))
    theirs = copy.deepcopy(ours)
    state = ttrainer.TrainState(ours)
    opt = torch.optim.SGD(theirs.parameters(), lr=1.0, momentum=MOMENTUM,
                          weight_decay=WD, dampening=0)
    x = torch.randn(6, 5)
    for lr in (1e-2, 3e-2, 5e-3):
        for model in (ours, theirs):
            model.zero_grad()
            model(x).square().mean().backward()
        ttrainer.sgd_update(state, lr, MOMENTUM, WD)
        opt.param_groups[0]["lr"] = lr
        opt.step()
    for a, b in zip(ours.parameters(), theirs.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-6, atol=1e-8)


# -- train steps from one bridged init ---------------------------------------


def _np_batches(seed, count):
    """``count`` batches [B, 96, 96, 3] with 1-3 boxes per image, as tuples
    of numpy arrays in ``Batch`` order (targets from ``assign_numpy``)."""
    rng = np.random.default_rng(seed)
    h, w = HW
    out = []
    for k in range(count):
        image = rng.integers(0, 255, (B, h, w, 3), dtype=np.uint8)
        rows = []
        for _ in range(B):
            n = int(rng.integers(1, 4))
            x1 = rng.uniform(0, w - 34, n)
            y1 = rng.uniform(0, h - 34, n)
            bl = np.stack([x1, y1, x1 + rng.uniform(10, 33, n),
                           y1 + rng.uniform(10, 33, n)], -1)
            rows.append(assign_numpy(bl, rng.integers(0, 20, n), HW,
                                     mode="v2", max_boxes=M))
        fields = [np.stack([r[i] for r in rows]) for i in range(6)]
        out.append((image, *fields, np.arange(B, dtype=np.int32) + B * k))
    return out


def _jbatch(arrays):
    return JBatch(*(jnp.asarray(a) for a in arrays[:-1]), arrays[-1])


def _tbatch(arrays):
    return next(device_prefetch([Batch(*arrays)], "cpu"))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _state_tree(jstate):
    return _np_tree({"params": jstate.params, "batch_stats": jstate.batch_stats,
                     "momentum": jstate.momentum, "step": jstate.step})


def _jax_state(tree):
    """A fresh JAX TrainState from a numpy tree's params and batch_stats."""
    return jtrainer.TrainState.create(jax.tree.map(
        jnp.asarray, {k: tree[k] for k in ("params", "batch_stats")}))


def _torch_state(tree):
    state = ttrainer.TrainState(fresh_yolov2())
    state.load_state_dict(train_state_from_jax(tree))
    return state


def _rel_l2(got_tree, ref_tree):
    """(global, worst per-tensor) relative l2 distance of two trees."""
    got, ref = jax.tree.leaves(got_tree), jax.tree.leaves(ref_tree)
    assert len(got) == len(ref)
    num = den = worst = 0.0
    for g, r in zip(got, ref):
        d = float(np.linalg.norm(np.asarray(g, np.float64) - r))
        n = float(np.linalg.norm(np.asarray(r, np.float64)))
        num, den = num + d * d, den + n * n
        worst = max(worst, d / max(n, 1e-12))
    return (num ** 0.5) / max(den ** 0.5, 1e-12), worst


# Epoch-1 warm-up learning rates, a new one every step.  The base rate is
# 1e-4 because a free run across two frameworks is chaotic: f32 convolution
# noise flips a LeakyReLU sign here and there (at 96x96 the 3x3x1024 maps of
# stages 6-7 hold few elements, so one flip moves the gradient upstream of it
# by about a percent), and the drift grows with the step size.
LRS = [jschedule.StagedSchedule([1e-4], [2]).step_lr(1, (k + 1) / STEPS)
       for k in range(STEPS)]
METRICS = ("loss", "loss_xy", "loss_wh", "loss_conf", "loss_noobj", "loss_cls")


@pytest.fixture(scope="module")
def runs():
    """Three steps (momentum 0.9, weight decay 5e-4, warm-up lrs) in both
    packages from one flax init: per step the metrics and the state after
    it, as numpy trees.  The first step, from zero buffers, is also the
    ``momentum=0.0`` update."""
    jmodel = JaxYOLOv2(dtype=jnp.float32)
    # Jitted: a quarter of the eager init's time, the same leaves.
    variables = jax.jit(jmodel.init)(
        jax.random.key(0), jnp.zeros((1,) + HW + (3,), jnp.uint8)
    )
    init_tree = _state_tree(jtrainer.TrainState.create(variables))
    batches = _np_batches(7, STEPS)

    jstep = jtrainer.make_train_step(
        jmodel, "v2", JLambdas(), jmodel.anchors, momentum=MOMENTUM,
        weight_decay=WD,
    )
    jstate = jtrainer.TrainState.create(variables)
    jax_out = []
    for k in range(STEPS):
        jstate, m = jstep(jstate, _jbatch(batches[k]), jnp.float32(LRS[k]),
                          jax.random.key(k))
        jax_out.append(({n: float(m[n]) for n in METRICS}, _state_tree(jstate)))

    tstep = ttrainer.make_train_step(
        "v2", Lambdas(), jmodel.anchors, momentum=MOMENTUM, weight_decay=WD
    )
    tstate = _torch_state(init_tree)
    torch_out = []
    for k in range(STEPS):
        tstate, m = tstep(tstate, _tbatch(batches[k]), LRS[k])
        torch_out.append(({n: float(m[n]) for n in METRICS},
                          jax_from_train_state(tstate.state_dict())))
    return dict(jmodel=jmodel, init=init_tree, batches=batches,
                jax=jax_out, torch=torch_out)


def _delta(tree, init):
    return jax.tree.map(lambda a, b: a - b, tree["params"], init["params"])


def test_one_train_step_matches_jax(runs):
    """Loss and its five parts rtol 1e-4 (measured 4e-6).  The update
    direction (the momentum buffer after the first step, g + wd*p) within
    6e-2 relative l2 over all parameters: measured 0.3e-2 to 1.8e-2 over
    five batches, all of it upstream of one flipped LeakyReLU sign, while
    every tensor downstream of the flip agrees to 3e-5.  The updated
    parameters within 1e-5 globally, the BN running statistics within 1e-5
    globally and 1e-4 per tensor."""
    (jm, jt), (tm, tt) = runs["jax"][0], runs["torch"][0]
    for name in METRICS:
        np.testing.assert_allclose(tm[name], jm[name], rtol=1e-4, err_msg=name)
    assert int(tt["step"]) == int(jt["step"]) == 1
    glob, _ = _rel_l2(tt["momentum"], jt["momentum"])
    assert glob < 6e-2, glob
    # The head and the neck sit downstream of every LeakyReLU: tight.
    for tensor in (("Conv_0", "kernel"), ("ConvBnLeaky_0", "Conv_0", "kernel")):
        g, r = tt["momentum"], jt["momentum"]
        for key in tensor:
            g, r = g[key], r[key]
        assert _rel_l2(g, r)[0] < 1e-3, tensor
    glob, _ = _rel_l2(tt["params"], jt["params"])
    assert glob < 1e-5, glob
    glob, worst = _rel_l2(tt["batch_stats"], jt["batch_stats"])
    assert glob < 1e-5 and worst < 1e-4, (glob, worst)
    # The step moved every parameter, BN scale/bias and conv biases too
    # (weight decay reaches them all), and every running statistic.
    for kind in ("params", "batch_stats"):
        for new, old in zip(jax.tree.leaves(tt[kind]),
                            jax.tree.leaves(runs["init"][kind])):
            assert not np.array_equal(new, old)


def test_three_train_steps_with_momentum_match_jax(runs):
    """Free-running, momentum 0.9: each loss within rtol 5e-3 of JAX's
    (measured 4e-6, 4e-5, 4e-4; the bound asked of a free run is 1e-2); the
    final parameters within 5e-4 relative l2 globally (measured 4.3e-5) and
    their change since the init within 0.25 (measured 4.3e-2: a dropped
    momentum term or weight decay would be off by more than half); running
    statistics within 5e-4 (measured 4.3e-5); momentum buffers within 0.3
    (measured 6e-2)."""
    for k in range(STEPS):
        for name in METRICS:
            np.testing.assert_allclose(
                runs["torch"][k][0][name], runs["jax"][k][0][name],
                rtol=5e-3, err_msg=f"step {k} {name}",
            )
    jt, tt = runs["jax"][-1][1], runs["torch"][-1][1]
    assert int(tt["step"]) == int(jt["step"]) == STEPS
    glob, _ = _rel_l2(tt["params"], jt["params"])
    assert glob < 5e-4, glob
    glob, _ = _rel_l2(_delta(tt, runs["init"]), _delta(jt, runs["init"]))
    assert glob < 0.25, glob
    glob, _ = _rel_l2(tt["batch_stats"], jt["batch_stats"])
    assert glob < 5e-4, glob
    glob, _ = _rel_l2(tt["momentum"], jt["momentum"])
    assert glob < 0.3, glob
    # Momentum matters: the buffers are not the last step's direction alone,
    # and the parameters moved further than three plain SGD steps would.
    first = runs["torch"][0][1]["momentum"]
    assert _rel_l2(tt["momentum"], first)[0] > 0.3


def test_train_state_crosses_the_bridge_exactly(runs):
    """JAX TrainState (after a step: non-zero momentum, step 1) -> port ->
    JAX, leaf for leaf; and the port's own state survives the round trip."""
    tree = runs["jax"][0][1]
    state = _torch_state(tree)
    assert state.step == 1
    back = jax_from_train_state(state.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    again = train_state_from_jax(back)
    sd = state.state_dict()
    assert again["step"] == sd["step"]
    for part in ("model", "momentum"):
        assert sorted(again[part]) == sorted(sd[part])
        for name, t in sd[part].items():
            assert torch.equal(t, again[part][name]), name
    # The tree loads into the JAX package's own TrainState.
    jstate = jtrainer.TrainState.create(
        {"params": back["params"], "batch_stats": back["batch_stats"]}
    ).replace(momentum=back["momentum"], step=jnp.asarray(back["step"]))
    assert int(jstate.step) == 1


def test_train_step_with_device_augmentation_matches_jax(runs, monkeypatch):
    """One step with augmentation on, the port fed the parameters replayed
    from the JAX step's key.  What the port's step feeds its model is held
    against ``augment_batch`` under that key: boxes and validity equal,
    images within one uint8 level (1.4e-4 of the pixels differ).  The
    random-init network with batch-statistics BN amplifies that input
    difference about thirtyfold (the un-augmented step agrees to 4e-6), so
    the losses are held to rtol 2e-2 (measured 3e-3) and the updated
    parameters (lr 1e-4) to 1e-4 relative l2."""
    jmodel, arrays = runs["jmodel"], runs["batches"][0]
    cfg_kw = dict(p_rotate=1.0, p_scale=1.0)
    jstep = jtrainer.make_train_step(
        jmodel, "v2", JLambdas(), jmodel.anchors, momentum=0.0,
        weight_decay=WD, augment_cfg=jaug.AugmentConfig(**cfg_kw),
    )
    rng = jax.random.key(42)
    jstate = _jax_state(runs["init"])
    jstate, jm = jstep(jstate, _jbatch(arrays), jnp.float32(1e-4), rng)

    aug_key = jax.random.split(rng)[1]  # as the JAX step derives it
    params = replay_params(aug_key, B, jaug.AugmentConfig(**cfg_kw), HW)
    calls = []

    def replayed(generator, images, boxes, valid, cfg, warp_impl="auto",
                 dp=None):
        assert dp is None  # one process
        out = taug.apply_augment(images, boxes, valid, params, cfg, warp_impl)
        calls.append((warp_impl, out))
        return out

    monkeypatch.setattr(ttrainer, "augment_batch", replayed)
    tstep = ttrainer.make_train_step(
        "v2", Lambdas(), jmodel.anchors, momentum=0.0, weight_decay=WD,
        augment_cfg=taug.AugmentConfig(**cfg_kw),
    )
    tstate = _torch_state(runs["init"])
    tstate, tm = tstep(tstate, _tbatch(arrays), 1e-4,
                       torch.Generator().manual_seed(0))
    ((impl, (img, box, ok)),) = calls
    assert impl == "auto"
    jb = _jbatch(arrays)
    ref_img, ref_box, ref_ok = jaug.augment_batch(
        aug_key, jb.image, jb.box, jb.valid, jaug.AugmentConfig(**cfg_kw),
        warp_impl="twopass",
    )
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref_ok))
    np.testing.assert_allclose(box.numpy(), np.asarray(ref_box), atol=1e-3)
    diff = np.abs(img.numpy().astype(np.int32) - np.asarray(ref_img, np.int32))
    assert diff.max() <= 1 and (diff != 0).mean() < 1e-3
    for name in METRICS:
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=2e-2, err_msg=name)
    # Augmentation changed the step: not the un-augmented loss.
    assert abs(float(tm["loss"]) - runs["torch"][0][0]["loss"]) > 1e-3
    glob, _ = _rel_l2(jax_from_train_state(tstate.state_dict())["params"],
                      _np_tree(jstate.params))
    assert glob < 1e-4, glob


@pytest.mark.parametrize("val_loss_mode", ["per_image", "batched"])
def test_eval_step_matches_jax(runs, val_loss_mode):
    """Running-statistics forward + loss on a batch whose last image has
    no box (a padded row), from the state after three steps, rtol 1e-4."""
    jmodel = runs["jmodel"]
    tree = runs["jax"][-1][1]
    arrays = list(_np_batches(9, 1)[0])
    arrays[0][-1] = 0
    for field in arrays[1:6]:
        field[-1] = 0
    arrays[6][-1] = False
    arrays[7][-1] = -1
    jeval = jtrainer.make_eval_step(
        jmodel, "v2", JLambdas(), jmodel.anchors, val_loss_mode=val_loss_mode
    )
    jstate = _jax_state(tree)
    ref = jeval(jstate, _jbatch(arrays))
    teval = ttrainer.make_eval_step(
        "v2", Lambdas(), jmodel.anchors, val_loss_mode=val_loss_mode
    )
    tstate = _torch_state(tree)
    before = copy.deepcopy(tstate.model.state_dict())
    got = teval(tstate, _tbatch(arrays))
    if val_loss_mode == "per_image":
        assert float(got[1]) == float(ref[1]) == B - 1
        np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-4)
    else:
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-4)
    for name, t in tstate.model.state_dict().items():
        assert torch.equal(t, before[name]), name  # eval moves nothing


# -- the epoch loop ----------------------------------------------------------


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    make_synthetic_voc(str(root), num_train=8, num_val=5, seed=1)
    return VOC(dataset_dir=str(root))


def _pipes(voc, hw=(64, 64), batch=4):
    train = DetectionPipeline(voc.train_dataset, hw, batch, max_boxes=8, seed=0)
    val = DetectionPipeline(voc.val_dataset, hw, batch, max_boxes=8,
                            shuffle=False, drop_remainder=False)
    return train, val


def _remove_checkpoints(folder):
    """A full-width train state is 400 MB on disk and pytest keeps the
    temporary folders of its last three runs: leave no checkpoint behind."""
    for path in folder.glob("*.ckpt"):
        path.unlink()


def test_trainer_fit_artifacts_and_resume(voc, tmp_path):
    """One epoch on the CPU with device augmentation writes the artifacts;
    a restored checkpoint continues to the same next-step loss."""
    config = TrainConfig(
        learning_rate_list=[1e-3], num_epoch_list=[1], batch_size=4,
        momentum=0.9, max_boxes=8, multiscale_sizes=(),
    )
    train_pipe, val_pipe = _pipes(voc)
    model = YOLOv2(dtype=torch.float32, device="cpu", seed=3)
    trainer = ttrainer.Trainer(
        model, train_pipe, val_pipe, config, str(tmp_path),
        augment_cfg=taug.AugmentConfig(),
    )
    state, history = trainer.fit()
    assert state.step == 2 and state.model is model
    for name in ("train_config.json", "metrics.jsonl", "training_result.pkl",
                 "best_model.ckpt", "final_model.ckpt"):
        assert (tmp_path / name).exists(), name
    with open(tmp_path / "training_result.pkl", "rb") as f:
        assert pickle.load(f) == history
    assert len(history["train_loss_mean_list"]) == 1
    assert all(np.isfinite(v[0]) and v[0] > 0 for v in history.values())
    kinds = [json.loads(line)["kind"]
             for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert kinds == ["train_epoch", "val_epoch"]

    batch = next(device_prefetch(
        DetectionPipeline(voc.train_dataset, (64, 64), 4, max_boxes=8,
                          shuffle=False, prefetch=0), "cpu"))

    def next_loss(st):
        _, m = trainer.train_step(st, batch, 1e-3,
                                  torch.Generator().manual_seed(9))
        return float(m["loss"])

    resumed = checkpoint.restore(
        str(tmp_path / "final_model.ckpt"),
        ttrainer.TrainState(YOLOv2(dtype=torch.float32, device="cpu", seed=4)),
    )
    assert resumed.step == 2
    for name, t in state.momentum.items():
        assert torch.equal(t, resumed.momentum[name]) and bool(t.any())
    assert next_loss(resumed) == pytest.approx(next_loss(state), rel=1e-6)
    assert resumed.step == 3

    # Params-only checkpoints round-trip too.
    named = dict(model.named_parameters())
    checkpoint.save_params(str(tmp_path / "params.ckpt"), named)
    loaded = checkpoint.restore_params(str(tmp_path / "params.ckpt"), named)
    assert all(torch.equal(loaded[k], v) for k, v in named.items())
    with pytest.raises(KeyError):
        checkpoint.restore_params(str(tmp_path / "params.ckpt"),
                                  {"head.weight": named["head.weight"]})
    _remove_checkpoints(tmp_path)


@pytest.mark.parametrize(
    "policy, epochs, repicks", [("reference", 2, [1]), ("every10", 11, [1, 11])]
)
def test_multiscale_policies(voc, tmp_path, policy, epochs, repicks):
    config = TrainConfig(num_epoch_list=[epochs], learning_rate_list=[1e-3],
                         multiscale_sizes=(64, 96), multiscale_policy=policy)
    train_pipe, val_pipe = _pipes(voc)
    trainer = ttrainer.Trainer(
        fresh_yolov2(), train_pipe, val_pipe, config, str(tmp_path)
    )
    seen = []
    train_pipe.set_image_size = lambda hw: seen.append(hw)
    for epoch in range(1, epochs + 1):
        before = len(seen)
        trainer._maybe_multiscale(epoch)
        assert (len(seen) > before) == (epoch in repicks)
    expected = [
        int(np.random.default_rng(config.seed + e).choice((64, 96)))
        for e in repicks
    ]
    assert seen == [(s, s) for s in expected]


@pytest.mark.parametrize(
    "kwargs, error, match",
    [(dict(train_drop_remainder=False), ValueError, "drop_remainder"),
     (dict(mode="v3"), ValueError, "9 \\(w, h\\) pixel anchors"),
     (dict(mode="v9"), ValueError, "mode")],
)
def test_trainer_rejections(voc, tmp_path, kwargs, error, match):
    train_pipe, val_pipe = _pipes(voc)
    if kwargs.pop("train_drop_remainder", True) is False:
        train_pipe.drop_remainder = False
    with pytest.raises(error, match=match):
        ttrainer.Trainer(fresh_yolov2(), train_pipe, val_pipe,
                         TrainConfig(), str(tmp_path), **kwargs)


def test_trainer_map_hook(voc, tmp_path, monkeypatch):
    """``eval_map_every=1``: two epochs at 64x64 on the CPU each write a
    ``map_eval`` row and keep ``best_map_model.ckpt``; the hook scores
    under the val pipeline's own class list, here a custom one (the
    synthetic labels' names in another order), not VOC's.  One batch of
    four images a split."""
    classes = list(reversed(voc.cls_list))
    train = DetectionPipeline(
        VOCDataset(voc.train_img_path_list[:4], voc.train_annot_list[:4]),
        (64, 64), 4, max_boxes=8, cls_list=classes, seed=0)
    val = DetectionPipeline(
        VOCDataset(voc.val_img_path_list[:4], voc.val_annot_list[:4]),
        (64, 64), 4, max_boxes=8, cls_list=classes, shuffle=False,
        drop_remainder=False)
    config = TrainConfig(learning_rate_list=[1e-3], num_epoch_list=[2],
                         batch_size=4, max_boxes=8, multiscale_sizes=())
    ckpts = tmp_path / "ckpts"
    trainer = ttrainer.Trainer(
        YOLOv2(dtype=torch.float32, device="cpu", seed=5), train, val,
        config, str(ckpts), eval_map_every=1, eval_map_conf_thre=0.01,
    )
    scored = []
    real = teval.evaluate_batched

    def spy(det, dataset, **kw):
        scored.append((det.cls_list, det.conf_thre, len(dataset), kw))
        return real(det, dataset, **kw)

    monkeypatch.setattr(teval, "evaluate_batched", spy)
    trainer.fit()
    assert scored == [(classes, 0.01, 4, dict(image_hw=(64, 64),
                                              batch_size=4, dp=None))] * 2
    rows = [json.loads(line)
            for line in (ckpts / "metrics.jsonl").read_text().splitlines()]
    assert [r["kind"] for r in rows] == ["train_epoch", "val_epoch",
                                        "map_eval"] * 2
    for r in rows[2::3]:
        assert 0.0 <= r["map_50_95"] <= r["map_50"] and r["eval_seconds"] > 0
    assert (ckpts / "best_map_model.ckpt").exists()
    _remove_checkpoints(ckpts)


@pytest.mark.parametrize(
    "argv, message",
    [(["--augment", "sideways"], "invalid choice"),
     (["--data-parallel", "2"], "differs from the 1 process"),
     (["--model-parallel", "2"], "model parallelism (2) is not supported"),
     (["--image-size", "100"], "multiple of 32")],
)
def test_cli_names_the_later_slice(argv, message, capsys):
    """Usage errors exit 2 before any training: a data x model mesh other
    than the launched world size (one process here: a data-parallel size
    of 2, a model axis of 2).  (``--augment host``, ``--data-parallel``
    and ``--model-parallel`` are ported now: ``test_cli_defaults``,
    ``tests/test_torch_parallel.py`` and
    ``tests/test_torch_model_axis.py``.)"""
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    assert exc.value.code == 2
    assert message in capsys.readouterr().err


def test_cli_parses_the_qat_flags():
    """``--qat CKPT`` and its three flags, with the JAX ``train.py``'s
    defaults (10 epochs, lr 1e-4, one calibration batch)."""
    args = cli.parse_args(["--model", "YOLOv2", "--qat", "x.ckpt"])
    assert (args.qat, args.qat_epochs, args.qat_lr,
            args.qat_calib_batches) == ("x.ckpt", 10, 1e-4, 1)
    args = cli.parse_args(["--model", "YOLOv2", "--qat", "x.ckpt",
                           "--qat-epochs", "3", "--qat-lr", "2e-3",
                           "--qat-calib-batches", "4"])
    assert (args.qat_epochs, args.qat_lr, args.qat_calib_batches) == (
        3, 2e-3, 4)
    assert cli.parse_args(["--model", "YOLOv2"]).qat is None


@pytest.mark.parametrize("model", ["YOLOv1", "YOLOv3"])
def test_cli_qat_is_yolov2_only(model, capsys):
    """The int8 engine hardcodes the Darknet-19/quadrant graph, so ``--qat``
    refuses the other models, as the JAX ``train.py`` does."""
    with pytest.raises(SystemExit) as exc:
        cli.parse_args(["--model", model, "--qat", "x.ckpt"])
    assert exc.value.code == 2
    assert "YOLOv2-only" in capsys.readouterr().err


def test_cli_qat_on_the_cpu(tmp_path):
    """``python -m odc_tpu_torch.train --qat`` end to end in a subprocess on
    a checkpoint of the port's seeded YOLOv2: calibration, one exact-mode
    epoch with device augmentation, and the four outputs.  A synthetic VOC
    of four train and four val images: one step, one val batch."""
    ckpt = tmp_path / "start.ckpt"
    checkpoint.save(str(ckpt), ttrainer.TrainState(fresh_yolov2()))
    make_synthetic_voc(str(tmp_path / "voc"), num_train=4, num_val=4)
    try:
        stdout = run_python(
            "-m", "odc_tpu_torch.train", "--device", "cpu",
            "--model", "YOLOv2", "--image-size", "64",
            "--batch-size", "4", "--qat", str(ckpt), "--qat-epochs", "1",
            "--augment", "device",
            "--dataset-dir", str(tmp_path / "voc"),
            "--ckpt-root", str(tmp_path / "ckpts"),
            timeout=QAT_CLI_LIMIT_S,
        ).stdout.decode()
        assert "QAT Epoch: 1 -->" in stdout
        (run_dir,) = (tmp_path / "ckpts" / "YOLOv2").iterdir()
        assert {p.name for p in run_dir.iterdir()} == {
            "best_qat_model.ckpt", "final_qat_model.ckpt", "int8_scales.npy",
            "metrics.jsonl"}
        assert np.load(run_dir / "int8_scales.npy").shape == (22, 2)
        rows = [json.loads(line) for line in
                (run_dir / "metrics.jsonl").read_text().splitlines()]
        assert [r["kind"] for r in rows] == ["qat_epoch", "qat_val_epoch"]
        assert all(np.isfinite(r.get("loss", r.get("loss_mean")))
                   for r in rows)
    finally:
        ckpt.unlink()
        for run_dir in (tmp_path / "ckpts").glob("*/*"):
            _remove_checkpoints(run_dir)


@pytest.mark.parametrize("model", ["YOLOv1", "YOLOv2", "YOLOv3"])
def test_cli_parses_the_ported_models(model):
    args = cli.parse_args(["--model", model, "--image-size", "64"])
    assert (args.model, args.image_size) == (model, 64)


def test_cli_defaults():
    """``--model`` defaults to YOLOv1 and ``--augment`` to ``host``, as the
    JAX package's ``train.py``; one process (``--data-parallel`` -1)."""
    args = cli.parse_args([])
    assert (args.model, args.device, args.augment) == ("YOLOv1", "cuda", "host")
    assert (args.data_parallel, args.model_parallel) == (-1, 1)
    assert cli.parse_args(["--augment", "device"]).augment == "device"
    assert cli.parse_args(["--no-augment"]).augment == "none"
    assert (args.eval_map, args.eval_map_every, args.eval_map_conf) == (
        False, 0, 0.05)


@pytest.mark.parametrize("argv, key, value", [
    (["--eval-map"], "eval_map", True),
    (["--eval-map-every", "2"], "eval_map_every", 2),
])
def test_cli_parses_the_map_flags(argv, key, value):
    assert getattr(cli.parse_args(argv), key) == value


def test_cli_eval_map_conf_reaches_both_uses(tmp_path, monkeypatch):
    """``--eval-map-conf`` is the threshold of the in-training hook and of
    the run after training, which is scored under the dataset's class list
    (the Trainer and the evaluator are stand-ins: no training here)."""
    import types

    import odc_tpu_torch.train as ttrain

    seen = {}

    class FakeTrainer:
        def __init__(self, model, *args, **kwargs):
            seen["trainer"] = kwargs
            self.model = model

        def fit(self, state):
            return types.SimpleNamespace(model=self.model), {}

    class FakeDetector:
        def __init__(self, model, cls_list, conf_thre):
            seen["detector"] = (list(cls_list), conf_thre)
            self.cls_list = list(cls_list)

    def fake_evaluate(det, dataset, image_hw, batch_size, dp):
        seen["evaluate"] = (len(dataset), image_hw)
        return {c: np.zeros(10) for c in det.cls_list}

    monkeypatch.setattr(ttrain, "Trainer", FakeTrainer)
    monkeypatch.setattr(teval, "Detector", FakeDetector)
    monkeypatch.setattr(teval, "evaluate_batched", fake_evaluate)
    cli.main(["--device", "cpu", "--synthetic", "--epochs", "1",
              "--batch-size", "4", "--image-size", "64", "--eval-map",
              "--eval-map-every", "3", "--eval-map-conf", "0.25",
              "--dataset-dir", str(tmp_path / "voc"),
              "--ckpt-root", str(tmp_path / "ckpts")])
    assert seen["trainer"]["eval_map_every"] == 3
    assert seen["trainer"]["eval_map_conf_thre"] == 0.25
    assert seen["detector"] == (VOC(str(tmp_path / "voc")).cls_list, 0.25)
    assert seen["evaluate"] == (8, (64, 64))


def test_cli_trains_on_the_cpu(tmp_path):
    """``python -m odc_tpu_torch.train`` end to end in a subprocess, on a
    synthetic VOC of four train and four val images."""
    make_synthetic_voc(str(tmp_path / "voc"), num_train=4, num_val=4)
    stdout = run_python(
        "-m", "odc_tpu_torch.train", "--device", "cpu",
        "--model", "YOLOv2",
        "--epochs", "1", "--batch-size", "4",
        "--image-size", "64", "--augment", "device",
        "--dataset-dir", str(tmp_path / "voc"),
        "--ckpt-root", str(tmp_path / "ckpts"),
        timeout=V2_CLI_LIMIT_S,
    ).stdout.decode()
    assert "Epoch: 1 -->" in stdout and "done; checkpoints in" in stdout
    (run_dir,) = (tmp_path / "ckpts" / "YOLOv2").iterdir()
    assert {p.name for p in run_dir.iterdir()} == {
        "train_config.json", "metrics.jsonl", "training_result.pkl",
        "best_model.ckpt", "final_model.ckpt"}
    _remove_checkpoints(run_dir)


def test_cli_trains_yolov1_on_the_cpu(tmp_path):
    """``--model YOLOv1`` at 64x64 (grid 2, from ``--image-size``) trains
    one epoch with device augmentation and dropout, and scores mAP with
    ``--eval-map-every`` (four train and four val images)."""
    make_synthetic_voc(str(tmp_path / "voc"), num_train=4, num_val=4)
    stdout = run_python(
        "-m", "odc_tpu_torch.train", "--device", "cpu",
        "--model", "YOLOv1", "--epochs", "1",
        "--image-size", "64", "--batch-size", "4", "--eval-map-every", "1",
        "--augment", "device",
        "--dataset-dir", str(tmp_path / "voc"),
        "--ckpt-root", str(tmp_path / "ckpts"),
        timeout=V1_CLI_LIMIT_S,
    ).stdout.decode()
    assert "Epoch: 1 --> mAP@.5:" in stdout
    (run_dir,) = (tmp_path / "ckpts" / "YOLOv1").iterdir()
    rows = [json.loads(line) for line in
            (run_dir / "metrics.jsonl").read_text().splitlines()]
    assert [r["kind"] for r in rows] == ["train_epoch", "val_epoch",
                                        "map_eval"]
    assert np.isfinite(rows[0]["loss_mean"]) and rows[0]["loss_mean"] > 0
    _remove_checkpoints(run_dir)
