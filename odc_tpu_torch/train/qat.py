"""QAT fine-tune driver: checkpoint -> calibrate -> fine-tune -> tuned ckpt.

Port of ``odc_tpu/train/qat.py``.  The epoch and checkpoint surface mirrors
:class:`~odc_tpu_torch.train.trainer.Trainer` (the same pipelines, device
prefetch, JSONL metrics, best and final checkpoints), but the step is
:func:`odc_tpu_torch.ops.qat.make_qat_train_step`: the forward is the int8
engine's fake-quant float twin (``exact=True``: the loss is evaluated on
the DEPLOYED engine bit for bit), BatchNorm statistics stay frozen, and the
activation scales are calibrated ONCE up front and then frozen.  They are
part of the deployed artifact, so they ship beside the tuned weights as
``int8_scales.npy`` (``make_infer_fn(model, int8_scales=np.load(...))``).

Per-epoch validation is the ENGINE's loss on the val pipeline (the number
QAT optimizes), with the trainer's batched masked-mean semantics, each
batch weighted by its real images (``img_id >= 0``); the best checkpoint
keys off it.

Data and model parallelism (``mesh=DataParallel``): data index 0's state is
broadcast over the data axis, the step sums the gradients of global-count
losses over it (``make_qat_train_step(dp=)``), the engine's val loss is
reduced over it and only global rank 0 writes files.  On a model axis the
model comes sharded (``parallel.shard_model``, which ``Trainer(mesh=)``
runs), the twin, the engine and its calibration run on each rank's output
channels of the wide convs, and the checkpoints are written gathered, in
the one-card format.
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from odc_tpu_torch.losses.yolo_loss import Lambdas
from odc_tpu_torch.parallel.mesh import broadcast_state, model_shards
from odc_tpu_torch.train import checkpoint as ckpt_lib
from odc_tpu_torch.train.trainer import TrainState, _loss, _targets_of
from odc_tpu_torch.utils.metrics import JsonlLogger


def calibrate_from_pipeline(model, pipeline, num_batches: int = 1):
    """Run the engine's activation calibration on the first ``num_batches``
    of a :class:`~odc_tpu_torch.data.pipeline.DetectionPipeline`
    (un-augmented pixels: calibration must see deployment-distribution
    inputs).  The f32 calibration convolutions run in IEEE f32 on a card
    (TF32 off inside this call only).  Returns the [22, 2] ranges on the
    model's device.  A model sharded over the mesh's model axis calibrates
    sharded: every rank of its model group calls with the same pipeline."""
    from odc_tpu_torch.ops.int8_engine import calibrate
    from odc_tpu_torch.ops.qat import ieee_f32_convs

    batches = iter(pipeline)
    try:
        images = [np.asarray(batch.image)
                  for batch in itertools.islice(batches, num_batches)]
    finally:
        close = getattr(batches, "close", None)
        if close is not None:
            close()  # stops a prefetch thread
    if not images:
        raise ValueError("empty pipeline: nothing to calibrate on")
    device = next(model.parameters()).device
    images = torch.from_numpy(np.concatenate(images, 0)).to(device)
    with ieee_f32_convs():
        return calibrate(model, images)


def make_engine_eval_step(model, lambdas: Lambdas, scales, stem: str = "s2d",
                          dp=None):
    """Val step on the DEPLOYED int8 engine: ``(state, batch) -> loss``, the
    batched masked-mean loss (a 0-dim tensor), weighted by real image count
    by the caller like the trainer's ``val_loss_mode='batched'`` path; with
    ``dp``, this rank's share of the global batch's loss (the engine runs
    sharded on a model axis)."""
    from odc_tpu_torch.ops.int8_engine import (
        scales_tensor, yolov2_int8_forward,
    )

    scales = scales_tensor(scales, next(model.parameters()).device)

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        y = yolov2_int8_forward(
            state.model, batch.image, scales=scales, stem=stem,
            num_anchor_box=model.num_anchor_box, num_cls=model.num_cls,
        )
        total, _ = _loss(model, "v2", y, tuple(batch.image.shape[1:3]),
                         _targets_of(batch), lambdas, model.anchors, dp)
        return total

    return eval_step


def finetune_qat(
    model,
    state: TrainState,
    train_pipeline,
    val_pipeline,
    scales,
    ckpt_path: str,
    epochs: int = 10,
    lr: float = 1e-4,
    momentum: float = 0.9,
    weight_decay: float = 5e-4,
    lambdas: Optional[Lambdas] = None,
    augment_cfg=None,
    warp_impl: str = "auto",
    stem: str = "s2d",
    exact: bool = True,
    seed: int = 0,
    mesh=None,
) -> Tuple[TrainState, dict]:
    """Fine-tune ``state`` (in place) against the frozen-scales int8 engine.

    Writes ``best_qat_model.ckpt`` (lowest engine val loss),
    ``final_qat_model.ckpt``, ``int8_scales.npy`` and ``metrics.jsonl``
    (rows of kind ``qat_epoch`` and ``qat_val_epoch``) under
    ``ckpt_path``.  The augmentation draws from a ``torch.Generator`` on
    the model's device seeded with ``seed``.  ``mesh``: a
    ``parallel.DataParallel`` whose data rank and size the pipelines carry;
    with a model axis, ``state.model`` must be sharded over it already
    (``parallel.shard_model`` before the state is built, as
    ``Trainer(mesh=)`` does), and every rank writes through the gathered
    state (global rank 0 writes the files).
    Returns ``(final_state, history)``."""
    from odc_tpu_torch.data.prefetch import device_prefetch
    from odc_tpu_torch.ops.qat import make_qat_train_step

    if (mesh is not None and mesh.model_size > 1
            and not model_shards(state.model)):
        raise ValueError(
            f"the mesh has a model axis of {mesh.model_size} but the model "
            "is not sharded: run parallel.shard_model(model, mesh) before "
            "building the TrainState (Trainer(mesh=) does)")
    lambdas = lambdas or Lambdas()
    device = next(state.model.parameters()).device
    qat_step = make_qat_train_step(
        model, lambdas, scales,
        momentum=momentum, weight_decay=weight_decay,
        stem=stem, exact=exact,
        augment_cfg=augment_cfg, augment_warp_impl=warp_impl, dp=mesh,
    )
    eval_step = make_engine_eval_step(model, lambdas, scales, stem=stem,
                                      dp=mesh)
    writer = mesh is None or mesh.is_writer
    if mesh is not None:
        broadcast_state(state, mesh)

    def save(name):
        sd = state.state_dict()  # every rank gathers the model axis's slices
        if writer:
            ckpt_lib.save(os.path.join(ckpt_path, name), sd)

    os.makedirs(ckpt_path, exist_ok=True)
    if writer:
        np.save(os.path.join(ckpt_path, "int8_scales.npy"),
                torch.as_tensor(scales).detach().cpu().numpy())
    logger = JsonlLogger(
        os.path.join(ckpt_path, "metrics.jsonl") if writer else None)

    generator = torch.Generator(device=device).manual_seed(seed)
    train_hist, val_hist = [], []
    min_val = float("inf")
    try:
        for epoch in range(1, epochs + 1):
            losses = []
            seen = 0
            t0 = time.time()
            for batch in device_prefetch(train_pipeline, device):
                seen += batch.image.shape[0]
                state, metrics = qat_step(state, batch, lr, generator)
                losses.append(metrics["loss"])
            train_loss = 0.0
            if losses:
                # One host sync at epoch end, not per step.
                train_loss = float(np.mean(torch.stack(losses).cpu().numpy()))
                logger.write(
                    kind="qat_epoch", epoch=epoch, loss_mean=train_loss,
                    lr=lr, images_per_sec=seen / max(time.time() - t0, 1e-9),
                )

            vals, weights = [], []
            for batch in device_prefetch(val_pipeline, device):
                vals.append(eval_step(state, batch))
                weights.append((batch.img_id >= 0).float().sum())
            if vals:
                vw = torch.stack([torch.stack(vals), torch.stack(weights)])
                if mesh is not None:
                    mesh.sum_(vw)
                v, w = vw.cpu().numpy().astype(np.float64)
                val_loss = float((v * w).sum() / max(w.sum(), 1.0))
            else:
                val_loss = 0.0
            logger.write(kind="qat_val_epoch", epoch=epoch, loss=val_loss)

            train_hist.append(train_loss)
            val_hist.append(val_loss)
            print(
                f"QAT Epoch: {epoch} --> Training: (Loss Mean: {train_loss})"
                f"    Engine Validation: (Loss: {val_loss})"
            )
            if val_loss < min_val:
                save("best_qat_model.ckpt")
                min_val = val_loss

        save("final_qat_model.ckpt")
    finally:
        logger.close()
    return state, {
        "train_loss_mean_list": train_hist,
        "val_loss_list": val_hist,
    }
