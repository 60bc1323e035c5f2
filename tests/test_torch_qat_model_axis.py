"""QAT on the mesh's model axis (``ops/int8_engine.py``, ``ops/qat.py`` and
``train/qat.py`` of the port on a model sharded by
``parallel.shard_model``) against one process and against the JAX
package, on the CPU with gloo.

Two gloo processes at (data 1, model 2) run ``tests/torch_dp_worker.py``'s
``qat`` entry once (the module fixture ``qat_runs``): the port's seeded
YOLOv2 init, f32 at 64x64, two images, 11 convs sharded (the wide convs of
stages 5-7 and the neck), under the scales of the one-process
``calibrate`` made here.  Meanwhile this process runs the JAX package's
``make_qat_train_step(exact=False)`` from the bridged weights.  Measured on
this box:

* the sharded calibration: ranges bitwise the one-process ``calibrate``'s
  (held at rtol 1e-5) and bitwise across the ranks;
* the sharded engine (stem s2d, every ``stop_after`` point and the head;
  the plain stem's head): bitwise the one-process engine's, which is
  bitwise the eager JAX engine's (``tests/test_torch_int8_engine.py``), so
  the sharded engine gives JAX's codes;
* one exact QAT step: the loss and its parts bitwise the one-process
  step's; the update 2.1e-5 relative l2 from the one-process update (held
  at 1e-3), 2.0e-3 at the worst leaf (held at 1e-2; at lr 1e-4 a deep
  kernel moves by about one f32 ulp, so after - before rounds);
* one twin step (``exact=False``) against JAX's, by the one-process
  bounds of ``tests/test_torch_qat.py::test_qat_step_matches_jax``: the
  losses within 4.4e-6 relative (held at 1e-4); the update 2.9e-3 relative
  l2 from JAX's (held at 5e-2), 0.210 at the worst leaf, stage 3's first
  conv bias (held at 0.3);
* the ranks' gathered states after each step, and the gradients of every
  replicated parameter, bitwise equal across the model group
  (``all_reduce_grads`` gives every rank model rank 0's replicated
  gradients; on the card cuDNN's weight gradients are not deterministic).
"""

import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from odc_tpu.data.pipeline import Batch as JBatch
from odc_tpu.losses.yolo_loss import Lambdas as JLambdas
from odc_tpu.models.yolov2 import YOLOv2 as JaxYOLOv2
from odc_tpu.ops import qat as jq
from odc_tpu.train import trainer as jtrainer
from odc_tpu_torch.models.convert_jax import (
    jax_from_state_dict, params_from_jax,
)
from odc_tpu_torch.ops import int8_engine as te
from odc_tpu_torch.parallel import DataParallel, ModelShard, model_axis_layers
from odc_tpu_torch.train import TrainState, finetune_qat

import torch_dp_worker
from torch_port_helpers import DP_WORKER, fresh_yolov2, launch_ranks

# 3x the two ranks' 34.8 s in a full tier-1 run (CHANGES.md).
RANKS_LIMIT_S = 104
RUNS = [("s2d", stop) for stop in torch_dp_worker.QAT_STOPS] + [
    ("plain", None)]
MODES = ("exact", "twin")


def _jax_twin_step(model, arrays, scales) -> dict:
    """JAX's ``make_qat_train_step(exact=False)`` (momentum 0.9, weight
    decay 5e-4) from ``model``'s bridged weights: the metrics and the
    update of every parameter in the port's names."""
    variables = jax_from_state_dict(model.state_dict())
    step = jq.make_qat_train_step(
        JaxYOLOv2(dtype=jnp.float32), JLambdas(), jnp.asarray(scales),
        momentum=0.9, weight_decay=5e-4, exact=False)
    state = jtrainer.TrainState.create(jax.tree.map(jnp.asarray, variables))
    before = params_from_jax(jax.tree.map(np.asarray, state.params))
    state, metrics = step(
        state, JBatch(*(jnp.asarray(a) for a in arrays[:-1]), arrays[-1]),
        jnp.float32(torch_dp_worker.QAT_LR), jax.random.key(0))
    after = params_from_jax(jax.tree.map(np.asarray, state.params))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "update": {n: after[n] - before[n] for n in after}}


@pytest.fixture(scope="module")
def qat_runs(tmp_path_factory):
    """Launch the two workers once; meanwhile run the JAX step.  Returns
    the ranks' results (through their standard output), the one-process
    scales, the names ``model_axis_layers`` gives and the JAX step."""
    out = tmp_path_factory.mktemp("qat_mp")
    model = torch_dp_worker.qat_model()
    arrays = torch_dp_worker.qat_arrays()
    scales = te.calibrate(model, torch.from_numpy(arrays[0]))
    np.save(out / "scales.npy", scales.numpy())
    with launch_ranks(2, [DP_WORKER, str(out), str(out), "qat"],
                      timeout=RANKS_LIMIT_S) as workers:
        reference = _jax_twin_step(model, arrays, scales.numpy())
        outputs = workers.wait()
    return dict(
        ranks=[torch.load(io.BytesIO(o), weights_only=False)
               for o, _ in outputs],
        scales=scales, jax=reference,
        axis_layers=sorted(f"{n}.weight" for n, _ in model_axis_layers(model)))


def test_the_wide_convs_are_sharded(qat_runs):
    want = qat_runs["axis_layers"]
    assert len(want) == 11 and "neck.conv.weight" in want
    assert all(r["sharded"] == want for r in qat_runs["ranks"])


def test_sharded_calibration_matches_one_process(qat_runs):
    """Each sharded layer's f32 output is gathered before its range: the
    ranges within rtol 1e-5 of the one-process ``calibrate``, and bitwise
    equal on both ranks."""
    r0, r1 = (r["ranges"] for r in qat_runs["ranks"])
    assert r0.shape == (22, 2) and torch.equal(r0, r1)
    torch.testing.assert_close(r0, qat_runs["scales"], rtol=1e-5, atol=0)


@pytest.mark.parametrize("stem, stop", RUNS,
                         ids=[f"{s}-{'head' if t is None else t}"
                              for s, t in RUNS])
def test_sharded_engine_is_the_one_process_engine(qat_runs, stem, stop):
    """The sharded engine's output at ``stop_after`` (codes 0-19, the neck
    input 21, the f32 neck output 22; None: the head) bitwise the
    one-process port engine's on the same weights, images and scales,
    and so the eager JAX engine's (``tests/test_torch_int8_engine.py``
    holds the one-process engine to it bit for bit); equal on both
    ranks."""
    r0, r1 = qat_runs["ranks"]
    assert r0["codes_equal"][stem, stop]
    assert r0["code_digests"][stem, stop] == r1["code_digests"][stem, stop]


def test_exact_step_loss_is_bitwise(qat_runs):
    """The exact step's loss is the engine's: every metric on both ranks
    equal to the one-process step's, bit for bit."""
    r0, r1 = (r["exact"] for r in qat_runs["ranks"])
    assert r0["metrics"] == r1["metrics"] == r1["metrics_one_card"]


@pytest.mark.parametrize("mode", MODES)
def test_step_update_matches_one_process(qat_runs, mode):
    """The gathered update within relative l2 1e-3 of the one-process
    update, and 1e-2 at the worst leaf."""
    out = qat_runs["ranks"][1][mode]
    assert out["update_rel_l2"] <= 1e-3, out["update_rel_l2"]
    assert out["update_worst_leaf"][0] <= 1e-2, out["update_worst_leaf"]


@pytest.mark.parametrize("mode", MODES)
def test_model_group_stays_in_step(qat_runs, mode):
    """Both ranks' gathered states after the step bitwise equal, and the
    gradients of every replicated parameter (conv biases, BN, the head,
    the narrow convs): model rank 0's on both ranks (``all_reduce_grads``),
    which the update from one process above holds to the one-card
    gradients."""
    r0, r1 = (r[mode] for r in qat_runs["ranks"])
    assert len(r0["digests"]) > 200 and r0["digests"] == r1["digests"]
    assert len(r0["replicated_grads"]) > 50
    assert r0["replicated_grads"] == r1["replicated_grads"]


def test_model_group_takes_rank_zeros_replicated_gradients(qat_runs):
    """``all_reduce_grads`` with each rank's gradients set to its global
    rank + 1: the sharded slices keep their own (a data axis of one), the
    replicated parameters take model rank 0's, so the replicas cannot
    drift apart where the backward kernels are not deterministic."""
    for rank, r in enumerate(qat_runs["ranks"]):
        assert r["grad_values"] == {"replicated": [1.0],
                                    "sharded": [rank + 1.0]}


def test_sharded_twin_step_matches_jax(qat_runs):
    """The sharded twin step against JAX's ``make_qat_train_step(
    exact=False)`` from the bridged weights, by the one-process bounds of
    ``tests/test_torch_qat.py::test_qat_step_matches_jax``: the loss and
    its parts within rtol 1e-4, the update within 5e-2 relative l2 over
    all parameters and 0.3 at the worst leaf."""
    ref = qat_runs["jax"]
    twin = qat_runs["ranks"][0]["twin"]
    for name, want in ref["metrics"].items():
        np.testing.assert_allclose(twin["metrics"][name], want, rtol=1e-4,
                                   err_msg=name)
    got, want = twin["update"], ref["update"]
    assert got.keys() == want.keys()
    diff = {n: float((got[n].double() - w.double()).norm())
            for n, w in want.items()}
    norm = {n: float(w.double().norm()) for n, w in want.items()}
    total = (sum(d * d for d in diff.values())
             / sum(v * v for v in norm.values())) ** 0.5
    assert total < 5e-2, total
    worst = max(diff[n] / norm[n] for n in want)
    assert worst < 0.3, worst


@pytest.mark.parametrize("kw", [
    dict(valid_hw=np.array([[64, 64]])), dict(stem="s2d2"),
    dict(bf16_front=1),
], ids=["valid_hw", "s2d2", "bf16_front"])
def test_sharded_engine_refuses_the_unsharded_variants(kw):
    """``valid_hw``, the s2d2 stem and ``bf16_front`` do not run sharded:
    a clear error before any collective."""
    model = fresh_yolov2().eval()
    model.neck.conv.model_shard = ModelShard(None, 0, 2, 1024)
    images = torch.zeros((1, 64, 64, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="sharded over the mesh's model"):
        te.yolov2_int8_forward(model, images, np.ones((22, 2), np.float32),
                               **kw)


def test_finetune_qat_asks_for_a_sharded_model(tmp_path):
    """A mesh with a model axis and a model that is not sharded: a clear
    error (shard first, as ``Trainer(mesh=)`` does)."""
    model = fresh_yolov2()
    mesh = DataParallel(0, 1, torch.device("cpu"), model_size=2)
    with pytest.raises(ValueError, match="is not sharded"):
        finetune_qat(model, TrainState(model), None, None,
                     np.ones((22, 2), np.float32), ckpt_path=str(tmp_path),
                     mesh=mesh)
