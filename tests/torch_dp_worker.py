"""One rank of the two-process gloo group of ``tests/test_torch_parallel.py``.

    RANK=r WORLD_SIZE=2 MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/torch_dp_worker.py OUT_DIR DATA_DIR

Joins the group through ``maybe_initialize_distributed`` (the ``torchrun``
environment path) and writes ``OUT_DIR/rank<r>.pt``: YOLOv2 at 64x64 over
two data-parallel steps (global batch 4, momentum 0.9, device augmentation)
on a batch whose halves hold 3 and 5 boxes (the metrics, rank 0's step-1
update, digests of the state after step 2), and digests of the state after
one YOLOv1 step; then runs the training CLI (its default model, YOLOv1) with
``--data-parallel 2`` for one epoch.
The test imports :func:`yolov2_steps` to run the same steps in one
process.

The YOLOv2 runs in float64 (parameters and compute): in float32 a random
YOLOv2's step is chaotic at this size (the one-process run alone moves its
step-2 loss by 4e-4 relative between 1 and 4 CPU threads), which would
hide what the comparison is for; in float64 the two-process and
one-process runs agree to about 1e-14 on the losses."""

import hashlib
import os
import sys

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
    return slice(None) if dp is None else slice(2 * dp.rank, 2 * dp.rank + 2)


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
    return {k: hashlib.sha256(v.detach().contiguous().numpy().tobytes())
            .hexdigest() for k, v in tensors.items()}


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


def main(out_dir: str, data_dir: str) -> None:
    torch.set_num_threads(2)
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
    main(*sys.argv[1:3])
