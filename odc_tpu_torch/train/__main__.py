"""Training entry point of the port, the counterpart of the JAX package's
root ``train.py`` with its flag names.

Builds ``ckpts/<model>/<timestamp>``, constructs the VOC dataset, the model
and the pipelines, and runs the staged training schedule on ``--device``
(default ``cuda``; there is no silent move to the CPU).

    python -m odc_tpu_torch.train --model YOLOv2 --dataset-dir datasets
    python -m odc_tpu_torch.train --device cpu --synthetic --epochs 1 \\
        --batch-size 4 --image-size 64          # smoke run without a card

``--model`` defaults to YOLOv1, as the JAX package's ``train.py`` does;
``--image-size`` sets a YOLOv1's grid to ``size // 32``; a YOLOv3's three
heads follow the size (``size // 32``, ``// 16`` and ``// 8``).

``--eval-map-conf`` is the one confidence threshold of both mAP runs: the
in-training hook (``--eval-map-every``) and the run after training
(``--eval-map``).  The JAX package's ``train.py`` scores the latter at the
detector's default 0.9 instead.

``--qat CKPT`` (YOLOv2 only) fine-tunes a trained checkpoint against the
frozen-scales int8 engine instead of training (``train/qat.py``): it
calibrates the activation ranges on ``--qat-calib-batches`` un-augmented
train batches, runs ``--qat-epochs`` epochs at ``--qat-lr`` (momentum 0.9
unless ``--momentum`` says otherwise) and writes ``best_qat_model.ckpt``,
``final_qat_model.ckpt``, ``int8_scales.npy`` and ``metrics.jsonl``.
``--qat`` and ``--resume`` read this package's checkpoints and the JAX
package's (flax msgpack) alike.

    python -m odc_tpu_torch.train --model YOLOv2 --qat best_model.ckpt

``--augment`` defaults to ``host``, as the JAX package's ``train.py``: the
reference-order augmentation on the host (``data/host_augment.py``), on the
pipeline's prefetch thread.  ``--augment device`` runs the fused in-step
augmentation on the card instead, the fast choice there.

Data and model parallelism: one process per rank, launched by
``torchrun`` (the group comes from its environment, ``nccl`` on cards,
``gloo`` with ``--device cpu``), ``--data-parallel`` x ``--model-parallel``
ranks in all (``--data-parallel`` defaults to the world size over
``--model-parallel``).  Rank ``r`` is data index ``r // model`` and model
index ``r % model``.  Each data index reads its slice of every global
``--batch-size`` batch; the ranks of one model group share the output
channels of every kernel with at least 512 outputs.  Only global rank 0
writes checkpoints (gathered, in the one-card format; ``--resume`` shards
a full one) and metrics; the other ranks' folders end in `` rank<r>``.
``--qat`` runs on the same mesh: the one-card checkpoint is sharded as
``--resume`` shards it, and the calibration, the fake-quant twin and the
int8 engine run on each rank's output channels.

    torchrun --nproc-per-node 4 -m odc_tpu_torch.train --model YOLOv2
    torchrun --nproc-per-node 4 -m odc_tpu_torch.train --model YOLOv2 \\
        --data-parallel 2 --model-parallel 2
    torchrun --nproc-per-node 2 -m odc_tpu_torch.train --model YOLOv2 \\
        --qat best_model.ckpt --model-parallel 2
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys

def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m odc_tpu_torch.train", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--model", default="YOLOv1",
                   choices=["YOLOv1", "YOLOv2", "YOLOv3"])
    p.add_argument("--dataset-dir", default="datasets")
    p.add_argument("--ckpt-root", default="ckpts")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None,
                   help="override: single stage of N epochs")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--momentum", type=float, default=None)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--image-size", type=int, default=None,
                   help="square input-size override, multiple of 32 "
                   "(default: the model config's 224 v1 / 416 v2 and v3)")
    p.add_argument("--no-augment", action="store_true",
                   help="shorthand for --augment none")
    p.add_argument(
        "--augment", default="host", choices=["host", "device", "none"],
        help="host: reference-order augmentation on the host, on the "
        "pipeline's prefetch thread (default, as the JAX package). device: "
        "fused in-step augmentation on the training device (the fast "
        "choice on a card). none: disable.",
    )
    p.add_argument("--device", default="cuda",
                   help="torch device to train on; 'cpu' for smoke runs")
    p.add_argument("--synthetic", action="store_true",
                   help="generate and train on a tiny synthetic VOC")
    p.add_argument("--resume", default=None,
                   help="checkpoint path to resume from (this package's or "
                   "the JAX package's)")
    p.add_argument("--eval-map", action="store_true",
                   help="run batched VOC mAP on the val set after training")
    p.add_argument("--eval-map-every", type=int, default=0, metavar="N",
                   help="run streaming batched VOC mAP on the val set every "
                   "N epochs during training; logs kind='map_eval' rows to "
                   "metrics.jsonl and keeps best_map_model.ckpt")
    p.add_argument("--eval-map-conf", type=float, default=0.05,
                   help="confidence threshold of --eval-map-every and "
                   "--eval-map (low default: mAP needs the full PR curve)")
    p.add_argument("--qat", default=None, metavar="CKPT",
                   help="QAT mode (YOLOv2 only): fine-tune this trained "
                   "checkpoint against the frozen-scales int8 engine "
                   "(odc_tpu_torch.train.qat) instead of training; writes "
                   "best/final_qat_model.ckpt + int8_scales.npy")
    p.add_argument("--qat-epochs", type=int, default=10)
    p.add_argument("--qat-lr", type=float, default=1e-4)
    p.add_argument("--qat-calib-batches", type=int, default=1,
                   help="train batches (un-augmented) to calibrate "
                   "activation scales on")
    p.add_argument("--data-parallel", type=int, default=-1,
                   help="data-parallel processes (-1: the launcher's world "
                   "size, which any other value must equal)")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="ranks sharing the output channels of every kernel "
                   "with at least 512 outputs (data x model processes in "
                   "all)")
    args = p.parse_args(argv)

    aug_mode = "none" if args.no_augment else args.augment
    if args.image_size is not None and args.image_size % 32:
        p.error("--image-size must be a multiple of 32")
    if args.qat and args.model != "YOLOv2":
        p.error("--qat is YOLOv2-only (the int8 engine hardcodes the "
                "Darknet-19/quadrant graph)")
    args.augment = aug_mode
    return args


def main(argv=None) -> None:
    args = parse_args(argv)

    import torch

    from odc_tpu_torch.config import MeshConfig
    from odc_tpu_torch.parallel import (
        check_mesh, make_mesh, maybe_initialize_distributed,
    )
    # Under torchrun: join the group (a no-op in one process); each data
    # index's pipelines then read only its slice of every global batch.
    dp = maybe_initialize_distributed(device=args.device)
    try:
        try:
            check_mesh(MeshConfig(args.data_parallel, args.model_parallel),
                       dp)
        except ValueError as e:  # an argparse-style usage error
            print(f"python -m odc_tpu_torch.train: error: {e}",
                  file=sys.stderr)
            raise SystemExit(2)
        if dp is not None:
            dp = make_mesh(dp, args.model_parallel)
        _train(args, dp)
    finally:
        if dp is not None:
            torch.distributed.destroy_process_group()


def _train(args, dp) -> None:
    import dataclasses

    import torch

    from odc_tpu_torch.config import BATCH_SIZE, MODEL_CONFIG, TRAIN_CONFIG
    from odc_tpu_torch.data.pipeline import DetectionPipeline
    from odc_tpu_torch.data.host_augment import reference_augment
    from odc_tpu_torch.data.voc import VOC, make_synthetic_voc
    from odc_tpu_torch.models import model_from_config
    from odc_tpu_torch.ops.augment import AugmentConfig
    from odc_tpu_torch.parallel import rank_zero_first
    from odc_tpu_torch.train import Trainer, checkpoint

    # The pipelines read the data index's rows; folders are by global rank.
    pidx, pcnt = (0, 1) if dp is None else (dp.rank, dp.world_size)
    grank = 0 if dp is None else dp.global_rank
    ckpt_path = os.path.join(
        args.ckpt_root,
        args.model,
        datetime.datetime.now().strftime("%Y-%m-%d %H-%M-%S")
        + (f" rank{grank}" if grank else ""),
    )
    os.makedirs(ckpt_path, exist_ok=True)

    with rank_zero_first(dp):  # rank 0 writes the data and the index cache
        if args.synthetic:
            make_synthetic_voc(args.dataset_dir, num_train=16, num_val=8)
        dataset = VOC(dataset_dir=args.dataset_dir)

    model_cfg = dataclasses.replace(MODEL_CONFIG[args.model])
    if args.image_size is not None:
        model_cfg.image_size = (args.image_size, args.image_size)
        # v1's grid is size // 32 (224 -> S = 7), as in train.py; a model
        # takes only the fields it has (``config_fields``).
        model_cfg.num_grid_cell_in_height = args.image_size // 32
        model_cfg.num_grid_cell_in_width = args.image_size // 32
    image_size = model_cfg.image_size
    train_cfg = dataclasses.replace(
        TRAIN_CONFIG[args.model]["VOC2012"],
        batch_size=args.batch_size or BATCH_SIZE,
    )
    if args.epochs is not None:
        train_cfg.num_epoch_list = [args.epochs]
        train_cfg.learning_rate_list = [
            args.lr or train_cfg.learning_rate_list[0]
        ]
    if args.momentum is not None:
        train_cfg.momentum = args.momentum

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    device = args.device if dp is None else dp.device
    model = model_from_config(model_cfg, dtype=dtype, device=device,
                              seed=train_cfg.seed)
    print(f"device: {next(model.parameters()).device}")

    train_pipe = DetectionPipeline(
        dataset.train_dataset,
        image_hw=image_size,
        batch_size=train_cfg.batch_size,
        max_boxes=train_cfg.max_boxes,
        mode=model.mode,
        cls_list=dataset.cls_list,
        seed=train_cfg.seed,
        augment=reference_augment if args.augment == "host" else None,
        process_index=pidx,
        process_count=pcnt,
    )
    val_pipe = DetectionPipeline(
        dataset.val_dataset,
        image_hw=image_size,
        batch_size=train_cfg.batch_size,
        max_boxes=train_cfg.max_boxes,
        mode=model.mode,
        cls_list=dataset.cls_list,
        shuffle=False,
        # Validate over EVERY image like the reference; the tail batch is
        # padded, not dropped.
        drop_remainder=False,
        process_index=pidx,
        process_count=pcnt,
    )

    augment_cfg = AugmentConfig() if args.augment == "device" else None
    trainer = Trainer(
        model, train_pipe, val_pipe, train_cfg, ckpt_path=ckpt_path,
        augment_cfg=augment_cfg,
        eval_map_every=args.eval_map_every,
        eval_map_conf_thre=args.eval_map_conf,
        mesh=dp,
    )

    if args.qat:
        _finetune_qat(args, trainer, dataset, augment_cfg)
        return

    state = None
    if args.resume:
        state = checkpoint.restore(args.resume, trainer.init_state())
        print(f"resumed from {args.resume} at step {state.step}")

    state, _ = trainer.fit(state)
    print(f"done; checkpoints in {ckpt_path}")

    if args.eval_map:
        import numpy as np

        from odc_tpu_torch.eval import Detector, evaluate_batched

        det = Detector(state.model, cls_list=dataset.cls_list,
                       conf_thre=args.eval_map_conf)
        result = evaluate_batched(
            det, dataset.val_dataset, image_hw=image_size,
            batch_size=train_cfg.batch_size, dp=dp,
        )
        aps = np.stack([result[c] for c in dataset.cls_list])
        print(f"mAP[.5:.95]: {aps.mean():.4f}  mAP@.5: {aps[:, 0].mean():.4f}")


def _finetune_qat(args, trainer, dataset, augment_cfg) -> None:
    """``--qat``: restore the checkpoint into the trainer's fresh state,
    calibrate on un-augmented train batches, fine-tune against the int8
    engine with the trainer's pipelines, loss weights and folder."""
    from odc_tpu_torch.data.pipeline import DetectionPipeline
    from odc_tpu_torch.train import (
        calibrate_from_pipeline, checkpoint, finetune_qat,
    )

    cfg = trainer.config
    state = checkpoint.restore(args.qat, trainer.init_state())
    print(f"QAT from {args.qat} (step {state.step})")
    # Calibration must see un-augmented deployment-distribution pixels.
    calib_pipe = DetectionPipeline(
        dataset.train_dataset,
        image_hw=trainer.train_pipeline.image_hw,
        batch_size=cfg.batch_size,
        max_boxes=cfg.max_boxes,
        mode="v2",
        cls_list=dataset.cls_list,
        shuffle=False,
    )
    scales = calibrate_from_pipeline(trainer.model, calib_pipe,
                                     num_batches=args.qat_calib_batches)
    finetune_qat(
        trainer.model, state, trainer.train_pipeline, trainer.val_pipeline,
        scales, ckpt_path=trainer.ckpt_path, epochs=args.qat_epochs,
        lr=args.qat_lr,
        # QAT is a new capability, not reference parity: real momentum by
        # default.
        momentum=args.momentum if args.momentum is not None else 0.9,
        weight_decay=cfg.weight_decay, lambdas=trainer.lambdas,
        augment_cfg=augment_cfg, seed=cfg.seed, mesh=trainer.dp,
    )
    print(f"done; QAT checkpoints + int8_scales.npy in {trainer.ckpt_path}")


if __name__ == "__main__":
    main()
