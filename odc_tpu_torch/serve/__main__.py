"""Export a trained checkpoint as a self-contained serving engine.

    python -m odc_tpu_torch.serve --model YOLOv2 \
        --ckpt ckpts/YOLOv2/<ts>/best_model.ckpt --out yolov2.odce \
        --image-size 416 --batch-size 256 [--int8] [--calib images.npy]

Port of ``odc_tpu/serve/__main__.py``.  The checkpoint is a full train
state (``best_model.ckpt`` / ``final_model.ckpt``) or, with
``--params-only``, a params-only file, each of this package or of the JAX
package (``train/checkpoint.py`` reads both).  ``--int8`` bakes the full
int8 PTQ engine (YOLOv2): its ranges come from ``--scales`` (the
``int8_scales.npy`` a ``--qat`` run wrote), else from calibration on
``--calib`` (uint8 [N, H, W, 3] .npy) or, without it, on seeded noise.
The program is exported on ``--device`` (default ``cuda``) and runs there.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="YOLOv2",
                   choices=["YOLOv1", "YOLOv2", "YOLOv3"])
    p.add_argument("--ckpt", required=True)
    p.add_argument("--params-only", action="store_true",
                   help="--ckpt is a save_params file, not a train state")
    p.add_argument("--out", required=True)
    p.add_argument("--image-size", type=int, default=None,
                   help="square input size (default: 224 v1 / 416 v2, v3)")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--dynamic-batch", action="store_true",
                   help="export with a symbolic batch dimension: one "
                   "artifact serves every batch size")
    p.add_argument("--conf-thre", type=float, default=0.9)
    p.add_argument("--iou-thre", type=float, default=0.5)
    p.add_argument("--max-keep", type=int, default=64)
    p.add_argument("--class-wise", action="store_true")
    p.add_argument("--compact", action="store_true",
                   help="per-box (label, score) outputs instead of the "
                   "full class-score tensor")
    p.add_argument("--int8", action="store_true",
                   help="full-int8 PTQ engine (YOLOv2 only)")
    p.add_argument("--int8-dynamic", action="store_true",
                   help="dynamic int8 on the wide 3x3 convs (YOLOv3 only; "
                   "no calibration)")
    p.add_argument("--int8-stem", default="s2d",
                   choices=["plain", "s2d", "s2d2"])
    p.add_argument("--calib", default=None,
                   help="uint8 [N,H,W,3] .npy for int8 calibration")
    p.add_argument("--scales", default=None,
                   help="precomputed [22,2] activation-range .npy (e.g. the "
                   "int8_scales.npy a QAT fine-tune wrote: QAT weights are "
                   "only valid with their frozen ranges); skips calibration")
    p.add_argument("--weights-dtype", default=None,
                   choices=["bfloat16", "float32"],
                   help="cast the baked weights (bfloat16 halves the "
                   "artifact; the bf16 compute path casts them anyway)")
    p.add_argument("--device", default="cuda",
                   help="device the program is exported on and runs on")
    return p.parse_args(argv)


def build_model(args, size: int):
    """The model ``--model`` at ``size``, compute dtype bf16, on
    ``--device`` (YOLOv1's grid is ``size // 32``)."""
    import dataclasses

    from odc_tpu_torch.config import MODEL_CONFIG
    from odc_tpu_torch.models import model_from_config

    if args.int8_dynamic and args.model != "YOLOv3":
        raise SystemExit("--int8-dynamic is YOLOv3-only (the v2 int8 engine "
                         "is --int8)")
    if args.int8 and args.model != "YOLOv2":
        raise SystemExit("--int8 is YOLOv2-only")
    cfg = dataclasses.replace(
        MODEL_CONFIG[args.model], image_size=(size, size),
        num_grid_cell_in_height=size // 32, num_grid_cell_in_width=size // 32)
    kw = {"int8_dynamic": True} if args.int8_dynamic else {}
    return model_from_config(cfg, dtype=torch.bfloat16, device=args.device,
                             **kw)


def main(argv=None):
    args = parse_args(argv)
    from odc_tpu_torch.serve import export_engine, save_engine
    from odc_tpu_torch.train import checkpoint

    size = args.image_size or (224 if args.model == "YOLOv1" else 416)
    model = build_model(args, size)
    if args.params_only:
        params = checkpoint.restore_params(
            args.ckpt, dict(model.named_parameters()))
        # BN statistics keep their init values, as the JAX command's do.
        model.load_state_dict(params, strict=False)
    else:
        from odc_tpu_torch.train.trainer import TrainState

        checkpoint.restore(args.ckpt, TrainState(model))
    device = next(model.parameters()).device

    int8_scales = None
    if args.int8:
        from odc_tpu_torch.ops.int8_engine import calibrate

        if args.scales:
            int8_scales = np.load(args.scales).astype(np.float32)
        else:
            if args.calib:
                calib = np.load(args.calib)
                if calib.shape[1:] != (size, size, 3) or calib.dtype != np.uint8:
                    raise SystemExit(
                        f"calibration images must be uint8 [N, {size}, "
                        f"{size}, 3]")
            else:
                print("WARNING: no --calib given; calibrating on synthetic "
                      "noise (use real images for deployment)")
                calib = np.random.default_rng(1).integers(
                    0, 256, (8, size, size, 3), dtype=np.uint8)
            with torch.no_grad(), torch.backends.cudnn.flags(allow_tf32=False):
                int8_scales = calibrate(
                    model.eval(), torch.from_numpy(calib).to(device))

    data = export_engine(
        model,
        batch_size=None if args.dynamic_batch else args.batch_size,
        image_hw=(size, size),
        conf_thre=args.conf_thre,
        iou_thre=args.iou_thre,
        max_keep=args.max_keep,
        class_wise=args.class_wise,
        compact=args.compact,
        int8_scales=int8_scales,
        int8_stem=args.int8_stem,
        weights_dtype=(getattr(torch, args.weights_dtype)
                       if args.weights_dtype else None),
    )
    save_engine(args.out, data)
    bs = "dynamic" if args.dynamic_batch else args.batch_size
    kind = ("int8" if args.int8 else
            "int8_dynamic" if args.int8_dynamic else "bf16")
    print(f"wrote {args.out}: {len(data) / 1e6:.1f} MB ({args.model} {kind}, "
          f"bs={bs}, {size}x{size}, {device.type})")


if __name__ == "__main__":
    main()
