"""Train/eval steps + the epoch/stage training loop.

Port of ``odc_tpu/train/trainer.py``:

* one ``train_step``: (device augmentation and target assignment →)
  forward with batch-statistics BatchNorm → decode → loss → backward → SGD
  update, all on the model's device; the only host↔device traffic is the
  input batch in and, once per epoch, the collected losses out;
* optimizer = torch-SGD semantics (``d = g + wd·p; buf = mu·buf + d;
  p -= lr·buf`` over every parameter, BN scale/bias and conv biases
  included).  The reference rebuilds its optimizer every step, which
  silently zeroes momentum — ``momentum=0.0`` reproduces that effective
  update; 0.9 gives the intended one;
* staged LRs with the epoch-1 warmup curve (``schedule.py``);
* per-epoch validation loss, best/final checkpoints, loss-history pickle and
  a ``train_config.json`` snapshot, plus restore/resume;
* the mAP-during-training hook (``eval_map_every``): streaming batched VOC
  mAP over the val dataset, a ``map_eval`` row in ``metrics.jsonl`` and a
  best-by-mAP checkpoint;
* multi-scale policy for v2 and v3 ("reference": size picked only at
  epoch 1; "every10": every 10 epochs);
* YOLOv3 (``mode="v3"``): the raw heads go to ``yolov3_loss``, which
  assigns its targets itself from the boxes, with the model's pixel
  anchors.

Unlike the JAX package's functional ``TrainState``, the state here is
updated IN PLACE: ``train_step`` mutates the model's parameters and BN
buffers and the momentum buffers, and returns the same object.

Validation runs batched at the pipeline's static size.

Data parallelism (``Trainer(mesh=DataParallel)``, ``parallel/mesh.py``):
each data index trains on its slice of every global batch; ``fit``
broadcasts data index 0's state, the step divides the loss by the global
batch's counts, sums the gradients over the data axis before the update
and reports the global loss, BatchNorm computes global-batch statistics,
the validation loss and the mAP hook are reduced over the data axis, and
only global rank 0 writes files.  A mesh with a model axis also shards the
wide kernels' output channels over it (``parallel.shard_model``, in
``Trainer.__init__``); checkpoints are written gathered.
"""

from __future__ import annotations

import json
import os
import pickle
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from odc_tpu_torch.config import TrainConfig, as_dict
from odc_tpu_torch.losses.yolo_loss import (
    Lambdas, yolo_loss, yolo_loss_per_image,
)
from odc_tpu_torch.losses.yolov3_loss import (
    yolov3_loss, yolov3_loss_per_image,
)
from odc_tpu_torch.ops.assign import YoloTargets, assign
from odc_tpu_torch.ops.augment import augment_batch
from odc_tpu_torch.parallel.mesh import (
    all_reduce_grads, broadcast_state, model_shards, shard_model,
)
from odc_tpu_torch.train import checkpoint as ckpt_lib
from odc_tpu_torch.train.schedule import StagedSchedule
from odc_tpu_torch.utils.metrics import JsonlLogger


class TrainState:
    """The full train state: ``model`` (parameters and BN buffers),
    ``momentum`` (one buffer per parameter, by parameter name) and ``step``.
    ``TrainState(model)`` is a fresh state: zero momentum, step 0.

    On a mesh's model axis (``parallel.shard_model``) the model and the
    momentum hold the rank's slices of the sharded weights, while
    :meth:`state_dict` gathers them (every rank of the model group must
    call it) and :meth:`load_state_dict` takes full tensors and keeps the
    rank's slices: a state dict has the one-card layout either way."""

    def __init__(self, model: torch.nn.Module, momentum=None, step: int = 0):
        self.model = model
        self.momentum: Dict[str, torch.Tensor] = (
            {n: torch.zeros_like(p) for n, p in model.named_parameters()}
            if momentum is None else momentum
        )
        self.step = step

    def state_dict(self) -> dict:
        shards = model_shards(self.model)

        def full(tree):
            return {k: shards[k].gather_full(v) if k in shards else v
                    for k, v in tree.items()}

        return {
            "model": full(self.model.state_dict()),
            "momentum": full(self.momentum),
            "step": int(self.step),
        }

    def load_state_dict(self, sd: dict) -> None:
        shards = model_shards(self.model)

        def local(tree):
            return {k: shards[k].local(v) if k in shards else v
                    for k, v in tree.items()}

        self.model.load_state_dict(local(sd["model"]), strict=True)
        if sorted(sd["momentum"]) != sorted(self.momentum):
            raise KeyError("momentum names differ from the model's parameters")
        momentum = local(sd["momentum"])
        with torch.no_grad():
            for name, buf in self.momentum.items():
                buf.copy_(momentum[name])
        self.step = int(sd["step"])


def _targets_of(batch) -> YoloTargets:
    return YoloTargets(
        cell=batch.cell, sig_txty=batch.sig_txty, twth=batch.twth,
        box=batch.box, cls=batch.cls, valid=batch.valid,
    )


def _check_mode(mode: str, anchors=None) -> None:
    if mode not in ("v1", "v2", "v3"):
        raise ValueError(f"mode must be 'v1', 'v2' or 'v3', got {mode!r}")
    if mode == "v3" and (anchors is None or len(anchors) != 9):
        raise ValueError(
            "mode='v3' needs the model's 9 (w, h) pixel anchors, got "
            f"{None if anchors is None else len(anchors)}")


def _loss(model, mode, y, image_hw, targets, lambdas, anchors, dp=None):
    """``(total, parts)`` of the raw head ``y`` of an ``image_hw`` batch;
    with ``dp``, this rank's share of the global batch's loss."""
    count_sum = None if dp is None else dp.sum_counts
    if mode == "v3":
        return yolov3_loss(y, targets, image_hw, anchors=anchors,
                           lambdas=lambdas, count_sum=count_sum)
    det = model.decode(y, image_hw)
    return yolo_loss(det, targets, lambdas, mode=mode, anchors=anchors,
                     count_sum=count_sum)


def sgd_update(
    state: TrainState, lr: float, momentum: float, weight_decay: float
) -> None:
    """torch-SGD update from the parameters' ``.grad``, in place:
    ``d = g + wd·p; buf = mu·buf + d; p -= lr·buf`` (no dampening, no
    Nesterov), over every parameter."""
    names, params = zip(*state.model.named_parameters())
    bufs = [state.momentum[n] for n in names]
    with torch.no_grad():
        d = torch._foreach_add([p.grad for p in params], params, alpha=weight_decay)
        torch._foreach_mul_(bufs, momentum)
        torch._foreach_add_(bufs, d)
        torch._foreach_add_(params, bufs, alpha=-lr)


def make_train_step(
    mode: str,
    lambdas: Lambdas,
    anchors=None,
    momentum: float = 0.0,
    weight_decay: float = 5e-4,
    augment_cfg=None,
    augment_warp_impl: str = "auto",
    on_phase: Optional[Callable[[str], None]] = None,
    dp=None,
) -> Callable:
    """Build the train step: ``(state, batch, lr, generator) -> (state,
    metrics)``; ``batch`` holds tensors on the model's device, ``metrics``
    0-dim tensors there (no host sync).  A YOLOv1 (``mode="v1"``) draws its
    dropout mask from ``generator``, after the augmentation's draws (the
    JAX step's ``rngs={"dropout": rng}``).

    With ``augment_cfg`` set, the on-device augmentation
    (``odc_tpu_torch.ops.augment``) runs inside the step, drawing from
    ``generator``, and targets are re-assigned on the device from the
    augmented boxes.  ``augment_warp_impl``: geometric-warp backend
    ("auto": the CUDA kernel for CUDA tensors, the plain two-pass warp for
    CPU tensors; see ``ops.augment._warp_images``).

    ``on_phase`` (measurement only): called with "augment", "forward",
    "loss", "backward", "update" as each part of the step has been
    enqueued.

    ``dp`` (a ``parallel.DataParallel``): ``batch`` is this rank's slice of
    the global batch.  The augmentation keeps the rank's rows of the global
    draws, BatchNorm reduces its statistics over the ranks, the loss
    divides by the global counts, the gradients are summed over the ranks
    before the update (one bucket) and ``metrics`` are the global batch's,
    equal on every rank."""
    _check_mode(mode, anchors)
    mark = on_phase or (lambda name: None)

    def train_step(state: TrainState, batch, lr: float, generator=None):
        model = state.model
        model.train()
        if dp is not None:
            dp.attach(model)
        image = batch.image
        targets = _targets_of(batch)
        if augment_cfg is not None:
            with torch.no_grad():
                image, boxes, valid = augment_batch(
                    generator, image, batch.box, batch.valid, augment_cfg,
                    warp_impl=augment_warp_impl, dp=dp,
                )
                targets = assign(
                    boxes, batch.cls, valid, tuple(image.shape[1:3]), mode=mode
                )
        mark("augment")

        model.zero_grad(set_to_none=True)
        y = model(image, generator=generator) if mode == "v1" else model(image)
        mark("forward")
        loss, parts = _loss(model, mode, y, tuple(image.shape[1:3]), targets,
                            lambdas, anchors, dp)
        mark("loss")
        loss.backward()
        mark("backward")
        if dp is not None:
            all_reduce_grads(model.parameters(), dp)
        sgd_update(state, float(lr), momentum, weight_decay)
        state.step += 1
        mark("update")
        return state, step_metrics(loss, parts, dp)

    return train_step


def step_metrics(loss, parts, dp=None) -> Dict[str, torch.Tensor]:
    """The step's ``loss`` and parts as 0-dim tensors; with ``dp``, summed
    over the ranks (each rank's loss is its share of the global one)."""
    values = torch.stack([loss, *parts]).detach()
    if dp is not None:
        dp.sum_(values)
    names = ("loss", "loss_xy", "loss_wh", "loss_conf", "loss_noobj",
             "loss_cls")
    return dict(zip(names, values.unbind()))


def make_eval_step(
    mode: str,
    lambdas: Lambdas,
    anchors=None,
    val_loss_mode: str = "per_image",
    dp=None,
) -> Callable:
    """Build the val step: ``(state, batch) -> loss``.

    ``val_loss_mode="per_image"`` returns ``(loss_sum, image_count)`` with
    the reference's batch-size-1 semantics (per-image denominators, see
    :func:`odc_tpu_torch.losses.yolo_loss.yolo_loss_per_image`);
    ``"batched"`` returns the batch-global masked-mean loss (one scalar);
    with ``dp``, this rank's share of it (the ranks' values sum to it)."""
    _check_mode(mode, anchors)
    if val_loss_mode not in ("per_image", "batched"):
        raise ValueError(f"unknown val_loss_mode {val_loss_mode!r}")

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        model = state.model
        model.eval()
        y = model(batch.image)
        image_hw = tuple(batch.image.shape[1:3])
        targets = _targets_of(batch)
        if val_loss_mode == "per_image":
            if mode == "v3":
                losses, has_box = yolov3_loss_per_image(
                    y, targets, image_hw, anchors=anchors, lambdas=lambdas)
            else:
                losses, has_box = yolo_loss_per_image(
                    model.decode(y, image_hw), targets, lambdas, mode=mode,
                    anchors=anchors)
            return losses.sum(), has_box.float().sum()
        total, _ = _loss(model, mode, y, image_hw, targets, lambdas, anchors,
                         dp)
        return total

    return eval_step


class Trainer:
    """Epoch/stage loop mirroring the JAX package's ``Trainer``."""

    def __init__(
        self,
        model: torch.nn.Module,
        train_pipeline,
        val_pipeline,
        config: TrainConfig,
        ckpt_path: str,
        mode: Optional[str] = None,
        rng_seed: Optional[int] = None,
        augment_cfg=None,
        eval_map_every: int = 0,
        eval_map_conf_thre: float = 0.05,
        mesh=None,
    ) -> None:
        if not getattr(train_pipeline, "drop_remainder", True):
            raise ValueError(
                "train pipeline must use drop_remainder=True: padded tail "
                "rows are zero images that would feed BatchNorm batch "
                "statistics in train mode (padding is eval-only)"
            )
        self.model = model
        self.device = next(model.parameters()).device
        # ``mesh``: a ``parallel.DataParallel`` (the pipelines must carry
        # its data rank and size), or None for one process.  On a model
        # axis the model is sharded here, before any state is built.
        self.dp = mesh
        self.is_writer = mesh is None or mesh.is_writer
        if mesh is not None:
            shard_model(model, mesh)
        self.train_pipeline = train_pipeline
        self.val_pipeline = val_pipeline
        self.config = config
        self.ckpt_path = ckpt_path
        self.mode = mode or model.mode
        self.anchors = (
            getattr(model, "anchors", None)
            if self.mode in ("v2", "v3") else None
        )
        self.lambdas = Lambdas(
            config.lambda_xy, config.lambda_wh, config.lambda_conf,
            config.lambda_noobj, config.lambda_cls,
        )
        self.schedule = StagedSchedule(
            config.learning_rate_list,
            config.num_epoch_list,
            config.warmup_first_epoch,
        )
        # The augmentation's random stream, on the model's device.
        self.generator = torch.Generator(device=self.device).manual_seed(
            config.seed if rng_seed is None else rng_seed
        )
        self.train_step = make_train_step(
            self.mode, self.lambdas, self.anchors,
            momentum=config.momentum, weight_decay=config.weight_decay,
            augment_cfg=augment_cfg, dp=mesh,
        )
        self.val_loss_mode = getattr(config, "val_loss_mode", "per_image")
        self.eval_step = make_eval_step(
            self.mode, self.lambdas, self.anchors,
            val_loss_mode=self.val_loss_mode, dp=mesh,
        )
        # mAP hook: every ``eval_map_every`` epochs, streaming batched VOC
        # mAP over the val pipeline's dataset at ``eval_map_conf_thre``
        # (low by default: mAP needs the whole precision-recall curve).
        self.eval_map_every = int(eval_map_every)
        self.eval_map_conf_thre = float(eval_map_conf_thre)
        os.makedirs(ckpt_path, exist_ok=True)
        self.logger = JsonlLogger(
            os.path.join(ckpt_path, "metrics.jsonl") if self.is_writer
            else None)

    def init_state(self) -> TrainState:
        """A fresh train state around the trainer's model (zero momentum,
        step 0); the model keeps the weights it was built with."""
        return TrainState(self.model)

    # -- epochs ------------------------------------------------------------

    def run_train_epoch(self, state: TrainState, epoch: int):
        from odc_tpu_torch.data.prefetch import device_prefetch

        losses = []
        dataset_size = len(self.train_pipeline.dataset)
        seen = 0
        t0 = time.time()
        for batch in device_prefetch(self.train_pipeline, self.device):
            seen += batch.image.shape[0]
            lr = self.schedule.step_lr(epoch, seen / dataset_size)
            state, metrics = self.train_step(state, batch, lr, self.generator)
            losses.append(metrics["loss"])
        if not losses:
            return state, 0.0
        # One host sync at epoch end, not per step.
        losses = torch.stack(losses).cpu().numpy()
        dt = time.time() - t0
        self.logger.write(
            kind="train_epoch", epoch=epoch,
            loss_mean=float(np.mean(losses)),
            lr=self.schedule.stage_lr(epoch),
            images_per_sec=seen / max(dt, 1e-9),
        )
        return state, float(np.mean(losses))

    def run_val_epoch(self, state: TrainState, epoch: int) -> float:
        from odc_tpu_torch.data.prefetch import device_prefetch

        losses, weights = [], []
        for batch in device_prefetch(self.val_pipeline, self.device):
            if self.val_loss_mode == "per_image":
                # eval_step returns (Σ per-image losses, #images with
                # boxes); padded tail rows have no boxes and count zero.
                s, n = self.eval_step(state, batch)
                losses.append(s)
                weights.append(n)
            else:
                losses.append(self.eval_step(state, batch))
                # Padded tail rows carry img_id == -1: weight each batch by
                # its real image count.
                weights.append((batch.img_id >= 0).float().sum())
        if not losses:
            return 0.0
        losses, weights = torch.stack(losses), torch.stack(weights)
        if self.dp is not None:
            # Every rank holds its slice of the same batches: sum each
            # batch's values and weights over the ranks.
            both = self.dp.sum_(torch.stack([losses, weights]))
            losses, weights = both[0], both[1]
        losses = losses.cpu().numpy().astype(np.float64)
        weights = weights.cpu().numpy().astype(np.float64)
        if self.val_loss_mode == "per_image":
            val = float(losses.sum() / max(weights.sum(), 1.0))
        else:
            val = float((losses * weights).sum() / max(weights.sum(), 1.0))
        self.logger.write(kind="val_epoch", epoch=epoch, loss=val)
        return val

    def run_map_eval(self, state: TrainState, epoch: int) -> dict:
        """Streaming batched VOC mAP on the val dataset at the val
        pipeline's size, scored under its class list.  Returns
        ``{"map_50": ..., "map_50_95": ...}`` and writes a
        ``kind="map_eval"`` row to metrics.jsonl."""
        from odc_tpu_torch.eval import Detector, evaluate_batched

        # A Detector folds the fused stem's weights when it is built, so one
        # is built for each evaluation, from the weights of the moment.
        det = Detector(state.model, cls_list=self.val_pipeline.cls_list,
                       conf_thre=self.eval_map_conf_thre)
        t0 = time.time()
        result = evaluate_batched(
            det,
            self.val_pipeline.dataset,
            image_hw=self.val_pipeline.image_hw,
            batch_size=self.val_pipeline.batch_size,
            dp=self.dp,
        )
        aps = np.stack([result[c] for c in det.cls_list])
        scores = {
            "map_50": float(aps[:, 0].mean()),
            "map_50_95": float(aps.mean()),
        }
        self.logger.write(
            kind="map_eval", epoch=epoch, eval_seconds=time.time() - t0,
            **scores,
        )
        return scores

    # -- full run ------------------------------------------------------------

    def _maybe_multiscale(self, epoch: int) -> None:
        # v2 as the reference; v3 trains multi-scale in darknet too.
        if self.mode not in ("v2", "v3") or not self.config.multiscale_sizes:
            return
        policy = self.config.multiscale_policy
        repick = (
            epoch == 1 if policy == "reference" else (epoch - 1) % 10 == 0
        )
        if repick:
            size = int(
                np.random.default_rng(self.config.seed + epoch).choice(
                    self.config.multiscale_sizes
                )
            )
            self.train_pipeline.set_image_size((size, size))

    def _save(self, name: str, state: TrainState) -> None:
        # Every rank gathers (the model axis's slices); the writer writes.
        sd = state.state_dict()
        if self.is_writer:
            ckpt_lib.save(os.path.join(self.ckpt_path, name), sd)

    def fit(self, state: Optional[TrainState] = None) -> Tuple[TrainState, dict]:
        if state is None:
            state = self.init_state()
        if self.dp is not None:
            broadcast_state(state, self.dp)

        if self.is_writer:
            with open(
                os.path.join(self.ckpt_path, "train_config.json"), "w"
            ) as f:
                json.dump(as_dict(self.config), f, indent=4, default=str)

        train_hist, val_hist = [], []
        min_val = float("inf")
        best_map = -1.0

        for epoch in self.schedule.epochs():
            self._maybe_multiscale(epoch)
            state, train_loss = self.run_train_epoch(state, epoch)
            val_loss = self.run_val_epoch(state, epoch)
            train_hist.append(train_loss)
            val_hist.append(val_loss)
            print(
                f"Epoch: {epoch} --> Training: (Loss Mean: {train_loss})    "
                f"Validation: (Loss: {val_loss})"
            )
            if val_loss < min_val:
                self._save("best_model.ckpt", state)
                min_val = val_loss
            if self.eval_map_every and epoch % self.eval_map_every == 0:
                scores = self.run_map_eval(state, epoch)
                print(
                    f"Epoch: {epoch} --> mAP@.5: {scores['map_50']:.4f}  "
                    f"mAP[.5:.95]: {scores['map_50_95']:.4f}"
                )
                if scores["map_50_95"] > best_map:
                    self._save("best_map_model.ckpt", state)
                    best_map = scores["map_50_95"]

        self._save("final_model.ckpt", state)
        history = {
            "train_loss_mean_list": train_hist,
            "val_loss_list": val_hist,
        }
        if self.is_writer:
            with open(
                os.path.join(self.ckpt_path, "training_result.pkl"), "wb"
            ) as f:
                pickle.dump(history, f)
        return state, history
