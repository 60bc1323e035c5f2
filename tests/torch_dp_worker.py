"""One rank of the gloo groups of ``tests/test_torch_parallel.py``,
``tests/test_torch_model_axis.py`` and
``tests/test_torch_qat_model_axis.py``.

    RANK=r WORLD_SIZE=2 MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/torch_dp_worker.py OUT_DIR DATA_DIR [model-axis|qat]

With ``model-axis``: :func:`main_model_axis`; with ``qat``:
:func:`main_qat` (DATA_DIR unused).  Otherwise:
Joins the group through ``maybe_initialize_distributed`` (the ``torchrun``
environment path) and writes ``OUT_DIR/rank<r>.pt``: YOLOv2 at 64x64 over
two data-parallel steps (global batch 4, momentum 0.9, device augmentation)
on a batch whose halves hold 3 and 5 boxes (the metrics, rank 0's step-1
update, digests of the state after step 2), and digests of the state after
one YOLOv1 step; then runs the training CLI (its default model, YOLOv1) with
``--data-parallel 2`` for one epoch.
The test imports :func:`yolov2_steps` to run the same steps in one
process.  A rank's intra-op threads are ``OMP_NUM_THREADS``'s
(``tests/torch_port_helpers.py::Children`` splits its test's budget).

The YOLOv2 runs in float64 (parameters and compute): in float32 a random
YOLOv2's step is chaotic at this size (the one-process run alone moves its
step-2 loss by 4e-4 relative between 1 and 4 CPU threads), which would
hide what the comparison is for; in float64 the two-process and
one-process runs agree to about 1e-14 on the losses."""

import contextlib
import hashlib
import io
import os
import sys
import zlib

import numpy as np
import torch

HW = (64, 64)
BOX_COUNTS = (1, 2, 4, 1)  # rank 0 holds 3 boxes, rank 1 holds 5
LR = 1e-3


def make_batch(mode: str, rows: slice):
    """Rows ``rows`` of one seeded global batch of 4 images, as tensors."""
    from odc_tpu_torch.data.pipeline import Batch
    from odc_tpu_torch.ops.assign import assign_numpy

    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (len(BOX_COUNTS),) + HW + (3,), np.uint8)
    targets = []
    for n in BOX_COUNTS:
        x1, y1 = rng.uniform(0, 36, n), rng.uniform(0, 36, n)
        boxes = np.stack([x1, y1, x1 + rng.uniform(8, 28, n),
                          y1 + rng.uniform(8, 28, n)], -1)
        targets.append(assign_numpy(boxes, rng.integers(0, 20, n), HW,
                                    mode=mode, max_boxes=8))
    batch = Batch(images, *(np.stack(f) for f in zip(*targets)),
                  np.arange(len(BOX_COUNTS), dtype=np.int32))
    return Batch(*(torch.from_numpy(np.ascontiguousarray(a[rows]))
                   for a in batch))


def _rows(dp):
    """The data index's rows of the global batch of 4."""
    if dp is None:
        return slice(None)
    n = len(BOX_COUNTS) // dp.world_size
    return slice(n * dp.rank, n * (dp.rank + 1))


def _step(model, mode, dp, state=None):
    from odc_tpu_torch.losses.yolo_loss import Lambdas
    from odc_tpu_torch.ops.augment import AugmentConfig
    from odc_tpu_torch.parallel import broadcast_state
    from odc_tpu_torch.train import TrainState, make_train_step

    state = TrainState(model)
    if dp is not None:
        broadcast_state(state, dp)
    step = make_train_step(mode, Lambdas(), getattr(model, "anchors", None),
                           momentum=0.9, augment_cfg=AugmentConfig(), dp=dp)
    return state, step


def digests(tensors: dict) -> dict:
    """A SHA-256 of each tensor's bytes: equal digests, equal bits."""
    return {k: hashlib.sha256(v.detach().contiguous().numpy()).hexdigest()
            for k, v in tensors.items()}


def yolov2_steps(dp=None, seed: int = 3) -> dict:
    """Two train steps of a seeded float64 YOLOv2: the metrics of each, the
    step-1 update of every parameter (as float32, plenty for a relative l2
    check), and the digests of the parameters, BN statistics and momentum
    after step 2."""
    from odc_tpu_torch.models.yolov2 import YOLOv2

    model = YOLOv2(dtype=torch.float64, device="cpu", seed=seed).double()
    state, step = _step(model, "v2", dp)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = make_batch("v2", _rows(dp))
    generator = torch.Generator().manual_seed(0)
    out = {}
    state, m1 = step(state, batch, LR, generator)
    out["metrics1"] = {k: float(v) for k, v in m1.items()}
    out["update1"] = {n: (p.detach() - before.pop(n)).float()
                      for n, p in model.named_parameters()}
    state, m2 = step(state, batch, LR, generator)
    out["metrics2"] = {k: float(v) for k, v in m2.items()}
    out["digests2"] = digests({
        **{f"model.{k}": v for k, v in state.state_dict()["model"].items()},
        **{f"momentum.{k}": v for k, v in state.momentum.items()}})
    return out


def yolov1_step(dp) -> dict:
    """The digests of the state after one step of a YOLOv1 (dropout 0.5:
    each rank draws its own mask)."""
    from odc_tpu_torch.models.yolov1 import YOLOv1

    model = YOLOv1(num_grid_cell_in_height=2, num_grid_cell_in_width=2,
                   image_size=HW, device="cpu", seed=dp.rank)
    state, step = _step(model, "v1", dp)
    state, _ = step(state, make_batch("v1", _rows(dp)), LR,
                    torch.Generator().manual_seed(1))
    return digests(state.state_dict()["model"])


def _model(name: str, seed: int, dtype=torch.float64):
    from odc_tpu_torch.models import YOLOv1, YOLOv2, YOLOv3

    kw = dict(dtype=dtype, image_size=HW, device="cpu", seed=seed)
    if name == "YOLOv1":
        model = YOLOv1(num_grid_cell_in_height=2, num_grid_cell_in_width=2,
                       **kw)
    else:
        model = {"YOLOv2": YOLOv2, "YOLOv3": YOLOv3}[name](**kw)
    return model.to(dtype)


def _train_step(model, dp):
    """One train step of ``model`` (sharded already on a mesh): global
    batch 4 of :func:`make_batch` (the data index's rows), momentum 0.9,
    device augmentation, the generator seeded 0.  Returns the state and
    the metrics as floats."""
    from odc_tpu_torch.losses.yolo_loss import Lambdas
    from odc_tpu_torch.ops.augment import AugmentConfig
    from odc_tpu_torch.train import TrainState, make_train_step

    # shard_model gave every rank global rank 0's weights: no
    # broadcast_state (the CLI's Trainer.fit runs it).
    state = TrainState(model)
    step = make_train_step(model.mode, Lambdas(),
                           getattr(model, "anchors", None), momentum=0.9,
                           augment_cfg=AugmentConfig(), dp=dp)
    batch = make_batch("v1" if model.mode == "v1" else "v2", _rows(dp))
    state, metrics = step(state, batch, LR, torch.Generator().manual_seed(0))
    return state, {k: float(v) for k, v in metrics.items()}


def model_axis_step(name: str, dp=None, seed: int = 3) -> dict:
    """One float64 train step of ``name`` (YOLOv1 with dropout 0.5, YOLOv2
    or YOLOv3) at 64x64, on the mesh ``dp`` (from ``make_mesh``; the model
    sharded over its model axis first) or in one process (None).  Returns
    the metrics, and the update of every parameter (as float32) from the
    one process or from global rank 0, whose weights ``shard_model`` sends
    to every rank.  On a mesh every rank adds the names of its sharded
    weights and the digests of the gathered state after the step; global
    rank 0 adds the names ``model_axis_layers`` gives and writes the
    gathered state with ``checkpoint.save`` (to memory: float64 states of
    up to 1.1 GB, a small disk), loads it into an unsharded copy of the
    initial model and records the tensors that differ."""
    import copy

    from odc_tpu_torch.parallel import (
        model_axis_layers, model_shards, shard_model,
    )
    from odc_tpu_torch.train import TrainState, checkpoint

    model = _model(name, seed)
    writer = dp is None or dp.is_writer
    result = {}
    if writer:
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
    if dp is not None:
        if writer:
            one_card = copy.deepcopy(model)
            result["axis_layers"] = sorted(f"{n}.weight" for n, _ in
                                           model_axis_layers(model))
        shard_model(model, dp)
    state, result["metrics"] = _train_step(model, dp)
    after = state.state_dict()  # gathered on a mesh
    if writer:
        result["update"] = {n: (after["model"][n] - b).float()
                            for n, b in before.items()}
    if dp is None:
        return result
    result["sharded"] = sorted(model_shards(model))
    result["digests"] = state_digests(after)
    if writer:
        buf = io.BytesIO()
        checkpoint.save(buf, after)
        buf.seek(0)
        one = TrainState(one_card)
        one.load_state_dict(torch.load(buf, weights_only=True))
        loaded = one.state_dict()
        result["checkpoint_step"] = loaded["step"]
        result["checkpoint_differs"] = [
            f"{part}.{k}" for part in ("model", "momentum")
            for k, v in after[part].items()
            if not torch.equal(loaded[part][k], v)
        ] + sorted(set(loaded["model"]) ^ set(after["model"]))
    return result


def state_digests(sd: dict) -> dict:
    """A CRC-32 of each tensor of a ``TrainState.state_dict()`` (a fifth of
    SHA-256's time on float64 states of 1 GB): two states with equal
    digests are equal bit for bit unless a difference happens to leave
    every one of the 32-bit checks unchanged."""
    return {k: zlib.crc32(v.detach().contiguous().numpy())
            for part in ("model", "momentum")
            for k, v in ((f"{part}.{n}", t) for n, t in sd[part].items())}


def main_model_axis(out_dir: str, data_dir: str) -> None:
    """``WORLD_SIZE`` 2: the (1, 2) mesh, one step of each model; 4: the
    (2, 2) mesh, one YOLOv2 step, then the training CLI (YOLOv1, float32)
    with ``--data-parallel 2 --model-parallel 2`` resuming from a one-card
    checkpoint global rank 0 writes (step 1); after it global rank 0
    deletes the checkpoints and adds ``"cli"``: the files of every rank's
    folder and whether the final checkpoint restores into a one-card
    YOLOv1, finite, at step 2.  Then, in a new group on ``QAT_MASTER_PORT``,
    the CLI's ``--qat`` (one epoch, device augmentation) on the same mesh
    from a one-card YOLOv2 checkpoint global rank 0 writes; global rank 0
    adds ``"qat"`` as ``"cli"`` (the final checkpoint at step 1) and
    deletes the checkpoints.  The results (:func:`model_axis_step`'s by
    model; rank 0's hold float32 updates of up to 0.6 GB, kept off the
    small disk) go to standard output as one ``torch.save`` payload;
    everything printed goes to standard error."""
    with contextlib.redirect_stdout(sys.stderr):
        result = _model_axis_run(out_dir, data_dir)
    buf = io.BytesIO()
    torch.save(result, buf)
    sys.stdout.buffer.write(buf.getvalue())
    sys.stdout.flush()


def _model_axis_run(out_dir: str, data_dir: str) -> dict:
    import torch.distributed as dist

    from odc_tpu_torch.parallel import make_mesh, maybe_initialize_distributed
    from odc_tpu_torch.train import TrainState, checkpoint
    from odc_tpu_torch.train.__main__ import main as cli_main

    dp = make_mesh(maybe_initialize_distributed(device="cpu"), 2)
    world = dp.world_size * dp.model_size
    names = ("YOLOv2", "YOLOv1", "YOLOv3") if world == 2 else ("YOLOv2",)
    # Each rank starts from other weights: shard_model must replace them
    # with global rank 0's.
    result = {name: model_axis_step(name, dp, seed=3 + dp.global_rank)
              for name in names}
    if world == 2:
        dist.destroy_process_group()
        return result
    cli_ckpt = os.path.join(out_dir, "YOLOv1-resume.ckpt")
    if dp.is_writer:
        checkpoint.save(cli_ckpt, TrainState(
            _model("YOLOv1", 3, torch.float32), step=1))
    dist.barrier()
    runs_dir = os.path.join(out_dir, "ckpts", "YOLOv1")
    cli_main(["--device", "cpu", "--model", "YOLOv1", "--dtype", "float32",
              "--augment", "device", "--epochs", "1", "--batch-size", "4",
              "--image-size", "64", "--data-parallel", "2",
              "--model-parallel", "2", "--resume", cli_ckpt,
              "--dataset-dir", data_dir,
              "--ckpt-root", os.path.dirname(runs_dir)])
    if dp.is_writer:
        os.unlink(cli_ckpt)
        result["cli"] = _cli_run(runs_dir, "final_model.ckpt",
                                 _model("YOLOv1", 0, torch.float32))
    # The CLI tore the group down: a new one carries the QAT run.
    os.environ["MASTER_PORT"] = os.environ["QAT_MASTER_PORT"]
    dist.init_process_group("gloo", init_method="env://")
    qat_ckpt = os.path.join(out_dir, "YOLOv2-qat.ckpt")
    if dist.get_rank() == 0:
        checkpoint.save(qat_ckpt, TrainState(
            _model("YOLOv2", 3, torch.float32), step=1))
    dist.barrier()
    runs_dir = os.path.join(out_dir, "ckpts", "YOLOv2")
    cli_main(["--device", "cpu", "--model", "YOLOv2", "--augment", "device",
              "--batch-size", "4", "--image-size", "64",
              "--data-parallel", "2", "--model-parallel", "2",
              "--qat", qat_ckpt, "--qat-epochs", "1",
              "--dataset-dir", data_dir,
              "--ckpt-root", os.path.dirname(runs_dir)])
    if dp.is_writer:  # the CLI tore the group down: the others are done
        os.unlink(qat_ckpt)
        result["qat"] = _cli_run(runs_dir, "final_qat_model.ckpt",
                                 _model("YOLOv2", 0, torch.float32))
    return result


def _cli_run(runs_dir: str, final: str, model) -> dict:
    """The files of every rank's folder under ``runs_dir``, and the step of
    the writer's ``final`` checkpoint restored into the one-card ``model``
    and whether it is finite; then the checkpoints are deleted."""
    from odc_tpu_torch.train import TrainState, checkpoint

    folders = {r: sorted(os.listdir(os.path.join(runs_dir, r)))
               for r in os.listdir(runs_dir)}
    (writer,) = [r for r in folders if " rank" not in r]
    state = checkpoint.restore(os.path.join(runs_dir, writer, final),
                               TrainState(model))
    for name in folders[writer]:
        if name.endswith(".ckpt"):
            os.unlink(os.path.join(runs_dir, writer, name))
    return {"folders": folders, "final_step": state.step,
            "final_finite": all(bool(t.isfinite().all()) for t in
                                state.model.state_dict().values())}


# -- QAT on the model axis ---------------------------------------------------

QAT_LR = 1e-4
# The engine's stop_after points: backbone convs 0-19, the neck input (21),
# the neck output (22); None runs to the head.
QAT_STOPS = (*range(20), 21, 22, None)


def qat_model():
    """The QAT runs' network: the port's seeded YOLOv2 init (BN at
    identity), f32, eval mode."""
    from odc_tpu_torch.models.yolov2 import YOLOv2

    return YOLOv2(dtype=torch.float32, device="cpu", seed=0).eval()


def qat_arrays():
    """The QAT runs' batch as numpy arrays in ``Batch`` order: two seeded
    64x64 images with 1-3 boxes each (targets from ``assign_numpy``, 4
    slots)."""
    from odc_tpu_torch.ops.assign import assign_numpy

    rng = np.random.default_rng(0)
    images = rng.integers(0, 255, (2,) + HW + (3,), dtype=np.uint8)
    rows = []
    for _ in range(len(images)):
        n = int(rng.integers(1, 4))
        x1 = rng.uniform(0, HW[1] - 34, n)
        y1 = rng.uniform(0, HW[0] - 34, n)
        boxes = np.stack([x1, y1, x1 + rng.uniform(10, 33, n),
                          y1 + rng.uniform(10, 33, n)], -1)
        rows.append(assign_numpy(boxes, rng.integers(0, 20, n), HW,
                                 mode="v2", max_boxes=4))
    fields = [np.stack([r[i] for r in rows]) for i in range(6)]
    return (images, *fields, np.arange(len(images), dtype=np.int32))


def _crc(t: torch.Tensor) -> int:
    return zlib.crc32(t.detach().contiguous().numpy())


def _qat_step(model, scales, exact, init, dp=None):
    """One QAT step (momentum 0.9, weight decay 5e-4, no augmentation) of
    ``model`` from the gathered state ``init`` on :func:`qat_arrays`'
    batch.  Returns the metrics as floats, the gathered state after the
    step and the ``.grad`` of every parameter."""
    from odc_tpu_torch.data.pipeline import Batch
    from odc_tpu_torch.losses.yolo_loss import Lambdas
    from odc_tpu_torch.ops.qat import make_qat_train_step
    from odc_tpu_torch.train import TrainState

    state = TrainState(model)
    state.load_state_dict(init)
    step = make_qat_train_step(model, Lambdas(), scales, momentum=0.9,
                               weight_decay=5e-4, exact=exact, dp=dp)
    batch = Batch(*(torch.from_numpy(a) for a in qat_arrays()))
    state, metrics = step(state, batch, QAT_LR)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return ({k: float(v) for k, v in metrics.items()}, state.state_dict(),
            grads)


def qat_model_axis(out_dir: str) -> dict:
    """The QAT path on a (1, 2) mesh, f32 at 64x64, the scales
    ``OUT_DIR/scales.npy`` (the test's one-process ``calibrate``).  Every
    rank returns its sharded calibration ranges; a CRC-32 of the sharded
    engine's output at each of :data:`QAT_STOPS` (stem s2d) and of its
    plain-stem head; for one exact (``"exact"``) and one twin (``"twin"``)
    QAT step from the same init, the metrics, the gathered state's digests
    and the digests of the replicated parameters' gradients; the gradient
    values ``all_reduce_grads`` leaves of ones set to global rank + 1
    (``"grad_values"``).  Then, with
    the group gone, each rank checks its half against an unsharded copy of
    the initial model: global rank 0 whether each engine output equals the
    unsharded engine's bit for bit (``"codes_equal"``), global rank 1 each
    step's one-process metrics and the relative l2 of the sharded update
    from the one-process update, globally and at the worst leaf.  Global
    rank 0 adds the twin step's update of every parameter (for the test's
    comparison with the JAX package)."""
    import copy

    import torch.distributed as dist

    from odc_tpu_torch.ops import int8_engine as te
    from odc_tpu_torch.parallel import (
        all_reduce_grads, make_mesh, maybe_initialize_distributed,
        model_shards, shard_model,
    )
    from odc_tpu_torch.parallel.mesh import shard_of
    from odc_tpu_torch.train import TrainState

    dp = make_mesh(maybe_initialize_distributed(device="cpu"), 2)
    scales = torch.from_numpy(np.load(os.path.join(out_dir, "scales.npy")))
    images = torch.from_numpy(qat_arrays()[0])
    model = qat_model()
    one_card = copy.deepcopy(model)
    shard_model(model, dp)
    sharded = model_shards(model)
    res = {"sharded": sorted(sharded),
           "ranges": te.calibrate(model, images)}
    runs = [("s2d", stop) for stop in QAT_STOPS] + [("plain", None)]
    codes = {(stem, stop): te.yolov2_int8_forward(
        model, images, scales, stem=stem, stop_after=stop)
        for stem, stop in runs}
    res["code_digests"] = {k: _crc(v) for k, v in codes.items()}
    # Gathered (the one-card layout) and copied: a state dict shares the
    # replicated tensors' storage with the model, which the steps move.
    init = {k: v if k == "step" else {n: t.clone() for n, t in v.items()}
            for k, v in TrainState(model).state_dict().items()}
    updates = {}
    for mode, exact in (("exact", True), ("twin", False)):
        metrics, after, grads = _qat_step(model, scales, exact, init, dp)
        res[mode] = {
            "metrics": metrics, "digests": state_digests(after),
            "replicated_grads": {n: _crc(g) for n, g in grads.items()
                                 if n not in sharded}}
        updates[mode] = {n: after["model"][n] - init["model"][n]
                         for n, _ in one_card.named_parameters()}
    # all_reduce_grads on gradients that differ by rank: the sharded ones
    # keep the rank's, the replicated ones become model rank 0's.
    for p in model.parameters():
        p.grad = torch.full_like(p, dp.global_rank + 1.0)
    all_reduce_grads(model.parameters(), dp)
    res["grad_values"] = {
        kind: sorted({v for p in model.parameters()
                      if (shard_of(p) is None) == (kind == "replicated")
                      for v in p.grad.unique().tolist()})
        for kind in ("replicated", "sharded")}
    dist.destroy_process_group()
    del model
    if dp.is_writer:
        res["codes_equal"] = {}
        for (stem, stop), got in codes.items():
            want = te.yolov2_int8_forward(one_card, images, scales,
                                          stem=stem, stop_after=stop)
            res["codes_equal"][stem, stop] = (
                got.dtype == want.dtype and torch.equal(got, want))
        res["twin"]["update"] = updates["twin"]
        return res
    for mode, exact in (("exact", True), ("twin", False)):
        out = res[mode]
        out["metrics_one_card"], ref, _ = _qat_step(one_card, scales, exact,
                                                    init)
        num = den = 0.0
        worst = (0.0, "")
        for n, u in updates[mode].items():
            want = ref["model"][n] - init["model"][n]
            d = float((u - want).norm())
            num += d * d
            den += float(want.norm()) ** 2
            worst = max(worst, (d / max(float(want.norm()), 1e-30), n))
        out["update_rel_l2"] = (num / den) ** 0.5
        out["update_worst_leaf"] = worst
    return res


def main_qat(out_dir: str) -> None:
    """:func:`qat_model_axis`'s result to standard output as one
    ``torch.save`` payload (rank 0's float32 update is 0.2 GB, kept off
    the small disk); everything printed goes to standard error."""
    with contextlib.redirect_stdout(sys.stderr):
        result = qat_model_axis(out_dir)
    buf = io.BytesIO()
    torch.save(result, buf)
    sys.stdout.buffer.write(buf.getvalue())
    sys.stdout.flush()


def main(out_dir: str, data_dir: str) -> None:
    from odc_tpu_torch.parallel import maybe_initialize_distributed
    from odc_tpu_torch.train.__main__ import main as cli_main

    dp = maybe_initialize_distributed(device="cpu")
    assert dp is not None and dp.world_size == 2
    # Rank 1 starts from other weights: broadcast_state must replace them.
    result = {"v2": yolov2_steps(dp, seed=3 + dp.rank),
              "v1": yolov1_step(dp)}
    if dp.rank:  # the ranks' updates are equal (test_torch_parallel.py)
        del result["v2"]["update1"]
    torch.save(result, os.path.join(out_dir, f"rank{dp.rank}.pt"))
    # The CLI reuses the group (and tears it down at its end).
    cli_main(["--device", "cpu", "--synthetic",
              "--epochs", "1", "--batch-size", "4", "--image-size", "64",
              "--data-parallel", "2", "--eval-map-every", "1",
              "--dataset-dir", data_dir,
              "--ckpt-root", os.path.join(out_dir, "ckpts")])


if __name__ == "__main__":
    if sys.argv[3:] == ["model-axis"]:
        main_model_axis(*sys.argv[1:3])
    elif sys.argv[3:] == ["qat"]:
        main_qat(sys.argv[1])
    else:
        main(*sys.argv[1:3])
