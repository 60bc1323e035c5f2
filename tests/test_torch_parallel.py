"""The port's multi-process data parallelism (``odc_tpu_torch/parallel``)
on the CPU with gloo.

Single process: the pipeline's process slices (against the one-process
pipeline and the JAX package's slices), the per-process augment stream,
the validation errors, the padded tail, and the cross-process BatchNorm
statistics in a one-rank group against ``torch.var_mean``.

Two processes (one spawn, ``tests/torch_dp_worker.py``): YOLOv2 at 64x64
in float64 (the worker says why), global batch 4, momentum 0.9, device augmentation, two steps on a batch
whose halves hold 3 and 5 boxes.  Both ranks' losses equal the one-process
run's within rtol 2e-5 (``tests/test_multihost.py``'s bound for the JAX
package) and each other's exactly; their states after step 2 are bitwise
equal; the step-1 update is within relative l2 5e-2 of the one-process
update, leaf by leaf (``tests/test_torch_train.py``'s bound).  YOLOv1
(per-rank dropout) is held only to equal states across ranks.  The same
workers then run the training CLI with ``--data-parallel 2``."""

import numpy as np
import pytest
import torch

from odc_tpu.data import pipeline as jpipeline
from odc_tpu.data import voc as jvoc
from odc_tpu.data.host_augment import reference_augment as jaugment
from odc_tpu_torch.data import pipeline as tpipeline
from odc_tpu_torch.data import voc as tvoc
from odc_tpu_torch.data.host_augment import reference_augment
from odc_tpu_torch.models.layers import TorchBatchNorm

import torch_dp_worker
from torch_port_helpers import DP_WORKER, free_port, launch_ranks

# 3x the two ranks' 29.8 s in a full tier-1 run (CHANGES.md).
RANKS_LIMIT_S = 89


# -- the pipeline's process slices (single process) ---------------------------


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    return tvoc.make_synthetic_voc(str(tmp_path_factory.mktemp("voc")),
                                   num_train=8, num_val=0, seed=4)


def _pipe(root, batch_size=4, module=tpipeline, vocmod=tvoc, **kw):
    return module.DetectionPipeline(
        vocmod.VOC(dataset_dir=root).train_dataset, image_hw=(64, 64),
        batch_size=batch_size, max_boxes=8, seed=11, prefetch=0, **kw)


def test_process_slices_partition_the_global_batch(voc_root):
    full = list(_pipe(voc_root))
    p0 = list(_pipe(voc_root, process_index=0, process_count=2))
    p1 = list(_pipe(voc_root, process_index=1, process_count=2))
    assert len(full) == len(p0) == len(p1) == 2
    for f, a, b in zip(full, p0, p1):
        assert a.image.shape[0] == b.image.shape[0] == 2
        for name, x, y, z in zip(f._fields, a, b, f):
            np.testing.assert_array_equal(np.concatenate([x, y]), z,
                                          err_msg=name)


@pytest.mark.parametrize("index", [0, 1])
def test_per_process_augment_stream_matches_jax(voc_root, index):
    """Host augmentation with two processes: the shuffle stream is shared,
    the augment stream is ``default_rng([seed, process_index])``; process
    ``index``'s batches equal the JAX package's bitwise."""
    kw = dict(process_index=index, process_count=2)
    ours = _pipe(voc_root, augment=reference_augment, **kw)
    theirs = _pipe(voc_root, module=jpipeline, vocmod=jvoc,
                   augment=jaugment, **kw)
    assert ours.rng is not ours._order_rng
    assert (ours.rng.bit_generator.state
            == np.random.default_rng([11, index]).bit_generator.state)
    for _ in range(2):
        for bo, bt in zip(list(ours), list(theirs), strict=True):
            for name, a, b in zip(bo._fields, bo, bt):
                np.testing.assert_array_equal(a, b, err_msg=name)


def test_process_sharding_validation(voc_root):
    with pytest.raises(ValueError, match="not divisible"):
        _pipe(voc_root, process_index=0, process_count=3)
    with pytest.raises(ValueError, match="process_index"):
        _pipe(voc_root, process_index=2, process_count=2)


def test_tail_batch_keeps_processes_in_lockstep(voc_root):
    """``drop_remainder=False``: 8 images at global batch 6 leave a tail of
    2: process 0 gets both and one padded row, process 1 a fully padded
    batch, and both yield the same number of batches."""
    kw = dict(batch_size=6, drop_remainder=False, shuffle=False)
    full = list(_pipe(voc_root, **kw))
    p0 = list(_pipe(voc_root, process_index=0, process_count=2, **kw))
    p1 = list(_pipe(voc_root, process_index=1, process_count=2, **kw))
    assert len(full) == len(p0) == len(p1) == 2
    assert p0[-1].image.shape[0] == p1[-1].image.shape[0] == 3
    np.testing.assert_array_equal(p0[-1].img_id[:2], full[-1].img_id[:2])
    assert (p0[-1].img_id[2:] == -1).all() and (p1[-1].img_id == -1).all()
    assert not p1[-1].valid.any() and not p1[-1].image.any()


# -- cross-process BatchNorm statistics, one rank -------------------------------


@pytest.fixture()
def one_rank_group():
    import torch.distributed as dist

    from odc_tpu_torch.parallel import maybe_initialize_distributed

    dp = maybe_initialize_distributed(
        device="cpu", init_method=f"tcp://localhost:{free_port()}",
        world_size=1, rank=0)
    yield dp
    dist.destroy_process_group()


def test_global_batchnorm_at_world_size_one(one_rank_group):
    """The two-pass formula against ``torch.var_mean`` within rtol 1e-6, on
    channels whose mean is large against their spread (where one-pass
    E[x^2] - E[x]^2 in f32 cancels), the running statistics, and the
    gradients."""
    gen = torch.Generator().manual_seed(0)
    shift = torch.tensor([0.0, 100.0, -300.0, 3.0])
    x = (torch.randn(2, 5, 7, 4, generator=gen) + shift).requires_grad_()
    plain, synced = TorchBatchNorm(4), TorchBatchNorm(4)
    one_rank_group.attach(torch.nn.Sequential(synced))
    assert synced.synced and not plain.synced
    y_plain, y_synced = plain(x), synced(x)
    var, mean = torch.var_mean(x.detach(), dim=(0, 1, 2), correction=0)
    from odc_tpu_torch.models.layers import global_var_mean

    g_var, g_mean, n = global_var_mean(x.detach())
    assert n.item() == 70
    np.testing.assert_allclose(g_mean.numpy(), mean.numpy(), rtol=1e-6)
    np.testing.assert_allclose(g_var.numpy(), var.numpy(), rtol=1e-6)
    np.testing.assert_allclose(y_synced.detach().numpy(),
                               y_plain.detach().numpy(), rtol=1e-5, atol=1e-5)
    for name in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(synced, name).numpy(),
                                   getattr(plain, name).numpy(), rtol=1e-6)
    w = torch.randn(y_plain.shape, generator=gen)
    (g_plain,) = torch.autograd.grad((y_plain * w).sum(), x)
    (g_synced,) = torch.autograd.grad((y_synced * w).sum(), x)
    np.testing.assert_allclose(g_synced.numpy(), g_plain.numpy(),
                               rtol=1e-4, atol=1e-5)


def test_remat_in_a_one_rank_group(one_rank_group):
    """``YOLOv2(remat=True)`` with BN reducing over the group: the
    recomputation repeats the statistics' all-reduces but moves the
    running statistics once; buffers and gradients after one forward and
    backward equal the run without remat, bit for bit."""
    import copy

    from torch_port_helpers import fresh_yolov2

    images = torch_dp_worker.make_batch("v2", slice(0, 2)).image
    runs = []
    plain = fresh_yolov2()
    for remat in (False, True):
        model = copy.deepcopy(plain).train()
        model.backbone.remat = remat
        one_rank_group.attach(model)
        model(images).square().mean().backward()
        runs.append(model)
    (p0, p1) = runs
    bufs = dict(p1.named_buffers())
    for name, b in p0.named_buffers():
        assert torch.equal(bufs[name], b), name
    grads = dict(p1.named_parameters())
    for name, p in p0.named_parameters():
        assert torch.equal(grads[name].grad, p.grad), name


def test_qat_step_in_a_one_rank_group(one_rank_group):
    """The QAT step's data-parallel wiring (global-batch draws, global
    counts, the gradient all-reduce, summed metrics) at world size 1: the
    same metrics and update as the plain step, bit for bit."""
    import copy

    from odc_tpu_torch.losses.yolo_loss import Lambdas
    from odc_tpu_torch.models.yolov2 import YOLOv2
    from odc_tpu_torch.ops.augment import AugmentConfig
    from odc_tpu_torch.ops.int8_engine import calibrate
    from odc_tpu_torch.ops.qat import make_qat_train_step
    from odc_tpu_torch.train import TrainState

    model = YOLOv2(dtype=torch.float32, device="cpu", seed=1).eval()
    batch = torch_dp_worker.make_batch("v2", slice(0, 2))
    scales = calibrate(model, batch.image)
    runs = []
    for dp in (None, one_rank_group):
        state = TrainState(copy.deepcopy(model))
        step = make_qat_train_step(state.model, Lambdas(), scales,
                                   augment_cfg=AugmentConfig(), dp=dp)
        _, metrics = step(state, batch, 1e-4, torch.Generator().manual_seed(2))
        runs.append((metrics, dict(state.model.named_parameters())))
    (m0, p0), (m1, p1) = runs
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(p0[k], p1[k]) for k in p0)


# -- two gloo processes ---------------------------------------------------------


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Launch the two workers once; meanwhile run the one-process
    reference.  Return their results, stdouts and output folder, and the
    reference run."""
    out = tmp_path_factory.mktemp("dp")
    try:
        with launch_ranks(2, [DP_WORKER, str(out), str(out / "voc")],
                          timeout=RANKS_LIMIT_S) as workers:
            reference = torch_dp_worker.yolov2_steps()
            outputs = workers.wait()
        ranks = [torch.load(out / f"rank{r}.pt") for r in (0, 1)]
        yield dict(ranks=ranks, stdout=[o.stdout.decode() for o in outputs],
                   out=out, reference=reference)
    finally:  # rank 0's update alone is 270 MB; checkpoints 175 MB each
        for path in [*out.glob("rank*.pt"), *out.glob("ckpts/**/*.ckpt")]:
            path.unlink()


def test_two_processes_train_as_one(two_ranks):
    ref = two_ranks["reference"]
    for rank in two_ranks["ranks"]:
        for key in ("metrics1", "metrics2"):
            got, want = rank["v2"][key], ref[key]
            assert set(got) == set(want)
            for name in want:
                np.testing.assert_allclose(got[name], want[name], rtol=2e-5,
                                           err_msg=f"{key} {name}")


def test_ranks_report_the_same_loss(two_ranks):
    r0, r1 = (r["v2"] for r in two_ranks["ranks"])
    assert r0["metrics1"] == r1["metrics1"]
    assert r0["metrics2"] == r1["metrics2"]


def test_ranks_hold_bitwise_equal_states(two_ranks):
    """Parameters, BN statistics and momentum after step 2, by digest."""
    r0, r1 = (r["v2"]["digests2"] for r in two_ranks["ranks"])
    assert len(r0) > 200 and r0 == r1


def test_step_one_update_matches_one_process(two_ranks):
    """Leaf by leaf, relative l2 of the update within 5e-2 (the conv biases
    before a train-mode BN included: in float64 their gradients' rounding
    noise is far below it)."""
    ref = two_ranks["reference"]["update1"]
    got = two_ranks["ranks"][0]["v2"]["update1"]  # rank 1's is equal
    assert got.keys() == ref.keys()
    for name, want in ref.items():
        rel = (got[name] - want).norm() / want.norm().clamp(min=1e-30)
        assert rel < 5e-2, (name, float(rel))


def test_yolov1_ranks_stay_equal(two_ranks):
    r0, r1 = (r["v1"] for r in two_ranks["ranks"])
    assert len(r0) > 100 and r0 == r1


def test_cli_data_parallel_writes_on_rank_zero(two_ranks):
    """``--data-parallel 2`` under the two workers: one epoch of the default
    model (YOLOv1) with host augmentation (the default) and the mAP hook; each rank has its own
    folder, only rank 0's holds checkpoints and metrics, and both print the
    same losses and mAP."""
    runs = sorted((two_ranks["out"] / "ckpts" / "YOLOv1").iterdir())
    assert len(runs) == 2
    rank0, rank1 = (runs if not runs[0].name.endswith(" rank1")
                    else runs[::-1])
    assert rank1.name.endswith(" rank1")
    assert {p.name for p in rank0.iterdir()} == {
        "train_config.json", "metrics.jsonl", "training_result.pkl",
        "best_model.ckpt", "best_map_model.ckpt", "final_model.ckpt"}
    assert list(rank1.iterdir()) == []
    lines = [[line for line in out.splitlines() if line.startswith("Epoch")]
             for out in two_ranks["stdout"]]
    assert len(lines[0]) == 2 and lines[0] == lines[1]
