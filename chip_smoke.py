#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``odc_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the ported paths from ``odc_tpu_torch/csrc``
with ``nvcc``, holds each kernel against its plain PyTorch version on the
card, then drives the main paths, each with the launch counts set to 0
just before and read just after:

* the conv blocks' fused epilogue (bias + BN + leaky + bf16 cast) — phase
  bias_bn_leaky: a YOLOv2-416 call at batch 64 and a YOLOv3-416 call at
  batch 256 with every block's output held bitwise against the block run
  on the unfused route, one launch a block, then the kernel's device ms a
  call beside its bound (4 bytes an element) and the plain version's;
* YOLOv4 — phase yolov4: a YOLOv4-608 call at batch 64 with every block
  (72 Mish, 35 leaky) held bitwise against the unfused route, one
  epilogue launch a block; the Mish epilogue (``csrc/bias_bn_mish.cu``)
  alone at each Mish shape of the call against its bound and the plain
  version, differing elements counted (0 required); ``make_infer_fn`` on
  the bulk cell's seeded weights against the plain f32 reference's decoded
  candidates, judged by the cell's limits, 1 NMS launch a call;
* serving — YOLOv2-416 bf16 end-to-end inference through ``make_infer_fn``
  (fused superstem -> Darknet-19 -> neck -> head -> decode -> NMS) on a few
  batches, checking that both kernels launched once per call and that the
  outputs agree with the unfused model;
* int8 serving — the same model through ``make_infer_fn(int8_scales=...)``
  after calibration on 32 images: the full int8 PTQ engine (s2d stem, 19
  backbone convs and the neck as int8 GEMMs of the hand-written matmul
  kernel, bf16 head) -> decode -> NMS, checking 20 GEMM launches per call,
  all on the GEMM's wgmma + TMA route, and 1 NMS launch, a kernel head
  bitwise equal to a plain-GEMM head, and the int8 head against the f32
  model; then the ``int8_neck`` path (fused stem, int8 neck: 1 superstem,
  1 GEMM, 1 NMS launch per call);
* native-size evaluation — the same model and scales through
  ``make_native_infer_fn`` on two padded VOC-shaped buckets of 16 (384x512
  and 512x384, odd and bucket-filling images), bf16 and int8, checking 1
  NMS launch a call, 20 GEMMs (all wgmma) an int8 call and no superstem;
  masked heads against native-size runs (the plain-stem int8 neck codes bit
  for bit), the NMS and each GEMM against their plain versions on this
  path's inputs, and the superstem at a native 375x500; then both
  evaluators end to end on 64 synthetic VOC JPEGs at three sizes, and the
  int8 engine's mAP@.5 on a YOLOv2 overfit at 96x96 (bf16 above 0.3, int8
  at most 0.15 below it);
* training — YOLOv2-416 bf16 at batch 32 through ``Trainer.fit`` with
  in-step device augmentation (warp kernel on the uint8 batch -> color ->
  box transform -> assign -> forward with batch-statistics BN -> loss ->
  backward -> SGD), two epochs of four steps on an in-memory synthetic
  dataset, checking that the warp kernel launched once per step, that the
  state moved, and that the checkpoint restores it;
* YOLOv1 — YOLOv1-224 bf16 (GoogLeNet -> Dense head -> decode_v1 -> NMS)
  through ``make_infer_fn``, a batch of 8 then batches of 512, checking 1
  NMS launch a call and no other kernel, each served layer (57 GoogLeNet
  conv units, the Dense head) against its f32 counterpart on the served
  inputs, with an fp8 control that must fail that check, and the NMS
  against its plain version on the path's candidates;
  ``Detector.detect`` on two JPEGs and ``evaluate_batched`` on 64; then
  YOLOv1-224 training at batch 32 (dropout 0.5) as above, the warp held
  against its plain version on the step's own images and maps;
* YOLOv3 — YOLOv3-416 bf16 (Darknet-53 -> FPN -> three heads -> decode_v3
  -> NMS over 10647 candidates an image) through ``make_infer_fn``, a batch
  of 8 then batches of 256, in bf16 (1 NMS launch a call, no other
  kernel) and with ``int8_dynamic`` (32 GEMM launches a call, all on the
  wgmma route, and 1 NMS); the NMS against its plain version on the
  path's candidates, every GEMM of one int8 call against the plain
  version and ``torch._int_mm``, each served int8 layer against its f32
  counterpart on the served input (a 4-bit control must fail that check);
  ``Detector.detect`` on two JPEGs and ``evaluate_batched`` on 64 in both
  precisions; the int8 mAP@.5 of a YOLOv3 overfit at 96x96 (bf16 above
  0.3, ``int8_dynamic`` at most 0.15 below it); then YOLOv3-416 training
  at batch 32 as above;
* serving — the YOLOv2-416 model exported with ``odc_tpu_torch.serve``,
  saved, loaded back and served at batch 64 in bf16 and int8_full (s2d):
  export s, artifact MB, load s, first call, 20 calls of the loaded program
  against the direct ``make_infer_fn`` call, ``predict`` with its numpy
  round trip, outputs equal to the direct call's, launches (1 superstem and
  1 NMS a bf16 call; 20 GEMMs, all wgmma, and 1 NMS an int8 call) counted
  inside the loaded program, no more device-to-host copies than the
  direct call; a symbolic-batch artifact behind the BatchingServer (8
  clients, 1024 single images: img/s, p50/p99, mean device batch); the HTTP
  door (4 clients x 8 POSTs of 16 images, annots equal the engine's); and
  YOLOv1-224 and YOLOv3-416 int8_dynamic artifacts at batch 8, equal to
  their direct calls;
* QAT — YOLOv2-416 fine-tuned against the int8 engine at batch 32
  (``train/qat.py::finetune_qat``, exact mode, device augmentation) after
  calibrating on one un-augmented batch: the fake-quant twin against the
  engine by the JAX QAT test's criteria for both stems (distances with
  TF32 off and on), exact mode ``torch.equal`` to the engine, 20 GEMM
  launches (all wgmma) and 1 warp a step and 20 GEMMs a validation batch,
  one step's GEMMs bitwise equal to plain and its warp within 1e-3, frozen
  BN, the shipped ``int8_scales.npy``, restored checkpoints serving through
  ``make_infer_fn(int8_scales=...)``; step time and parts; then a short
  QAT of the overfit 96x96 YOLOv2 lowers the engine's loss with its int8
  mAP@.5 within 0.15;
* the host data path — phase loader: the C++ JPEG loader built on the
  card's host (g++, libjpeg), ``decode_resize_batch`` to 416x416 on the 64
  eval JPEGs against PIL, and ``evaluate_batched`` (YOLOv2 bf16, batch 64)
  with the loader against PIL (PIL alone where the loader cannot build);
  phase host_augment: a YOLOv2-416 batch-32 ``Trainer`` epoch on synthetic
  375x500 VOC JPEGs with the reference-order host augmentation against the
  in-step device augmentation (ms/step, device busy share, 1 warp launch a
  device step and none a host step);
* CUDA graphs of a whole call — phase graph: ``make_infer_fn`` at the
  bulk cells' models, seeded weights and batches (YOLOv2-416 b64,
  YOLOv3-416 b256, YOLOv4-608 b64), every call graphed and eagerly on the
  same images (a forward hook keeps a call eager): differing elements
  counted (0 required), ms a call both ways, kernel launches equal a call,
  and ``graph_captures``/``graph_replays`` (one capture, a replay every
  call after the second);
* data parallelism — phase dp: a one-rank NCCL group, the data-parallel
  YOLOv2-416 train step at batch 32 with device augmentation against the
  plain step (f32 losses within rtol 1e-5), bf16 ms/step of both and the
  gradient all-reduce's device time; a failed NCCL init fails the run;
* remat — phase remat: the YOLOv2-416 batch-32 train step with device
  augmentation with and without ``remat`` from one init and one batch (f32
  losses within rtol 1e-5, BN running statistics equal after the step;
  bf16 ms/step, peak device memory and img/s through ``Throughput``, 1 warp
  launch a step);
* the mesh's model axis — phase mp: ``--model-parallel 2`` on YOLOv2-416 at
  batch 32, two spawned processes sharing the card over gloo (NCCL refuses
  two ranks on one device): the f32 loss within rtol 1e-5 and the gathered
  update within relative l2 1e-2 of the one-process step's, bf16 ms/step
  (gloo stages every collective through the host: not a measure of model
  parallelism's speed), 1 warp launch a step on each rank;
* QAT on the mesh's model axis — phase qat_mp: ``--qat --model-parallel
  2`` on YOLOv2-416 at batch 32 with device augmentation, two spawned
  processes sharing the card over gloo: the sharded calibration within
  rtol 1e-5 of one card's, the sharded engine's codes at every
  ``stop_after`` point and its head bitwise one card's, one exact f32
  step's loss bitwise one card's and its update within relative l2 1e-2
  of one card convolving as the mesh splits,
  the step's 20 GEMMs (11 on channel slices) bitwise equal to plain on
  the wgmma route and to the one-card GEMM's columns, ``finetune_qat`` on
  the mesh for one epoch (20 GEMMs a step and a validation batch and 1
  warp a step on each rank), the gathered checkpoint's one-card head
  bitwise the sharded one; ms/step, peak memory and the sliced GEMMs'
  times;
* YOLOv3's prefix probes — phase probe: each ``stop_after`` prefix of
  YOLOv3-416 bf16 at batch 256 timed with CUDA events, per-stage ms as
  differences of adjacent prefixes, one call traced by
  ``utils.profiler_trace`` into a temporary directory.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line
with each kernel's launches, error and times, and as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero without a result when no
card is present or any phase fails.  Weights and data are random, from
fixed seeds.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

import torch

DEVICE = "cuda"
SEED = 0
# Main-path shapes: YOLOv2-416, max_keep 64, batch 64.
HW = (416, 416)
BATCH = 64
MAX_KEEP = 64
N_CAND = 13 * 13 * 5
TIMED_CALLS = 20
# Training path: batch 32, 128 train and 32 val images, 2 epochs of 4 steps.
TRAIN_BATCH = 32
TRAIN_IMAGES, VAL_IMAGES = 128, 32
TRAIN_EPOCHS = 2
TIMED_STEPS = 12

# int8 path: calibration batch (as bench.py calibrates the JAX engine).
CALIB_IMAGES = 32

# YOLOv1 path: YOLOv1-224 (GoogLeNet, S=7, B=2, C=20), served at batch 512
# (the first batch of the JAX package's bench_yolov1), 98 candidates an
# image; trained at TRAIN_BATCH.
V1_HW = (224, 224)
V1_BATCH = 512


def _v1_kwargs(hw):
    """YOLOv1 at ``hw``: the grid is ``hw // 32`` (224 -> S = 7)."""
    return dict(num_grid_cell_in_height=hw[0] // 32,
                num_grid_cell_in_width=hw[1] // 32, image_size=hw)

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor-core,
# int8 tensor-core and f32 CUDA-core operations/s.
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
F32_FLOPS = 67e12


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def sync() -> None:
    torch.cuda.synchronize()


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Device time of ``fn()`` per call, from ``iters`` calls captured in
    one CUDA graph: the Python wrapper's host time between launches, which
    is longer than a small kernel, stays out of the timed region."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return time_ms(graph.replay, 5) / iters


def bound_ms(nbytes: float, flops: float, flops_rate: float):
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = flops / flops_rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_build():
    from odc_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    logs = build.build_all(verbose=True)
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s "
          f"with {build.nvcc_path()}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")


def _candidates(gen, batch, n, objects=24):
    """Heavily overlapping candidates on a 416-px canvas: each box jitters
    one of ``objects`` random boxes per image by up to 15% of its size."""
    obj_xy = torch.rand(batch, objects, 2, generator=gen) * 340
    obj_wh = 16 + torch.rand(batch, objects, 2, generator=gen) * 60
    pick = torch.randint(0, objects, (batch, n), generator=gen)
    xy = obj_xy.gather(1, pick[..., None].expand(-1, -1, 2))
    wh = obj_wh.gather(1, pick[..., None].expand(-1, -1, 2))
    jitter = (torch.rand(batch, n, 4, generator=gen) - 0.5) * 0.3
    boxes = torch.cat([xy, xy + wh], -1) + jitter * wh.repeat(1, 1, 2)
    conf = torch.rand(batch, n, generator=gen)
    return boxes, conf


def phase_nms():
    """Kernel vs plain suppression on the card, identical keep masks: on
    the main path's candidates, then in direct calls at edge-case K and B;
    times beside the launch floor."""
    from odc_tpu_torch.core.boxes import iou
    from odc_tpu_torch.core.nms import sorted_candidates
    from odc_tpu_torch.ops.cuda import build
    from odc_tpu_torch.ops.cuda.nms_kernel import suppress, suppress_plain

    gen = torch.Generator().manual_seed(SEED + 1)
    boxes, conf = _candidates(gen, BATCH, N_CAND)
    dboxes, dconf = boxes.to(DEVICE), conf.to(DEVICE)
    for conf_thre in (0.5, 0.9):
        for max_keep in (64, 128, 1024):
            order, cand, surv = sorted_candidates(
                dboxes, dconf, dconf >= conf_thre, max_keep
            )
            keep = suppress(cand, surv, 0.5)
            plain = suppress_plain(cand, surv, 0.5)
            c_order, c_cand, c_surv = sorted_candidates(
                boxes, conf, conf >= conf_thre, max_keep
            )
            c_keep = suppress(c_cand, c_surv, 0.5)  # CPU: the plain version
            if not (torch.equal(keep, plain) and torch.equal(keep.cpu(), c_keep)
                    and torch.equal(order.cpu(), c_order)):
                raise AssertionError(
                    f"NMS kernel != plain at conf {conf_thre}, "
                    f"max_keep {max_keep}"
                )
            print(f"nms conf {conf_thre} max_keep {max_keep}: kept "
                  f"{int(keep.sum())} of {int(surv.sum())} survivors, "
                  f"identical to plain (card and CPU)")
    # An IoU exactly at the threshold suppresses (>=) in both.
    pair = torch.tensor([[[0, 0, 10, 10], [5, 0, 15, 10]]],
                        dtype=torch.float32, device=DEVICE)
    ones = torch.ones(1, 2, dtype=torch.bool, device=DEVICE)
    thr = float(iou(pair[0, 0], pair[0, 1]))
    if suppress(pair, ones, thr).tolist() != [[True, False]]:
        raise AssertionError("NMS kernel: IoU == threshold did not suppress")

    # Direct calls at every K the kernel's word layout distinguishes (one
    # partial word, one full word less or more a box, the main path's 64,
    # the largest 1024) and batches below, at and above the 132 SMs, with
    # valid masks that are not prefixes, empty, and all kept.
    for k in (1, 31, 33, 64, 1024):
        for b in (1, 64, 200):
            boxes_k, _ = _candidates(gen, b, k)
            disjoint = torch.arange(k, dtype=torch.float32) * 20.0
            disjoint = torch.stack([disjoint, disjoint, disjoint + 10,
                                    disjoint + 10], -1).expand(b, k, 4)
            cases = {
                "random valid": (boxes_k, torch.rand(b, k, generator=gen) < 0.6),
                "all invalid": (boxes_k, torch.zeros(b, k, dtype=torch.bool)),
                "all kept": (disjoint, torch.ones(b, k, dtype=torch.bool)),
            }
            kept = {}
            for name, (bx, vd) in cases.items():
                bx = bx.contiguous().to(DEVICE)
                vd = vd.contiguous().to(DEVICE)
                keep = suppress(bx, vd, 0.5)
                plain = suppress_plain(bx, vd, 0.5)
                if not torch.equal(keep, plain):
                    raise AssertionError(f"NMS kernel != plain: {name}, K={k}, "
                                         f"B={b}")
                if name == "all kept" and not bool(keep.all()):
                    raise AssertionError(f"NMS: disjoint boxes dropped, K={k}")
                kept[name] = f"{int(keep.sum())}/{int(vd.sum())}"
            print(f"nms direct K={k} B={b}: kept {kept}, identical to plain")

    _, cand, surv = sorted_candidates(dboxes, dconf, dconf >= 0.5, MAX_KEEP)
    call_ms = time_ms(lambda: suppress(cand, surv, 0.5), 200)
    plain_call_ms = time_ms(lambda: suppress_plain(cand, surv, 0.5), 10)
    ms = graph_ms(lambda: suppress(cand, surv, 0.5), 100)
    plain_ms = graph_ms(lambda: suppress_plain(cand, surv, 0.5), 5)
    b, k = surv.shape
    # Where the time goes: an empty kernel with the same grid (the launch
    # floor), the kernel with nothing valid (loads and stores only), and
    # with every box kept (a walk step per candidate, the worst case).
    lib = build.load("nms_suppress")

    def floor_launch():
        build.check(lib.nms_launch_floor(
            b, k, torch.cuda.current_stream().cuda_stream), "nms_launch_floor")

    floor_ms = graph_ms(floor_launch, 100)
    none_valid = torch.zeros_like(surv)
    empty_ms = graph_ms(lambda: suppress(cand, none_valid, 0.5), 100)
    disjoint = torch.arange(k, dtype=torch.float32, device=DEVICE) * 20.0
    disjoint = torch.stack([disjoint, disjoint, disjoint + 10, disjoint + 10],
                           -1).expand(b, k, 4).contiguous()
    all_valid = torch.ones_like(surv)
    all_kept_ms = graph_ms(lambda: suppress(disjoint, all_valid, 0.5), 100)
    nbytes = b * k * (16 + 1 + 1)
    flops = b * (k * (k - 1) / 2 * 14 + k * 3)
    bms, by = bound_ms(nbytes, flops, F32_FLOPS)
    n_kept = int(suppress(cand, surv, 0.5).sum())
    print(f"nms B={b} K={k} ({int(surv.sum())} valid, {n_kept} kept), "
          f"device time per call in a CUDA graph: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms; per call from Python: "
          f"kernel {call_ms:.4f} ms, plain {plain_call_ms:.4f} ms; bound "
          f"{bms:.6f} ms ({by})")
    print(f"nms B={b} K={k} in a CUDA graph: launch floor (empty kernel, "
          f"same grid) {floor_ms:.4f} ms; nothing valid {empty_ms:.4f} ms; "
          f"all {k} kept (disjoint boxes) {all_kept_ms:.4f} ms; main "
          f"inputs {ms:.4f} ms, {ms - floor_ms:.4f} ms above the floor")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "max_abs_err": 0.0, "library_ms": None}


def _randomize_bn(model, gen):
    """Random BN running stats (mean N(0, 0.2), var U(0.5, 1.5)) so the
    folding is non-trivial."""
    from odc_tpu_torch.models.layers import TorchBatchNorm

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, TorchBatchNorm):
                n = m.running_mean.numel()
                m.running_mean.copy_(torch.randn(n, generator=gen) * 0.2)
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))


def _calibrate_bn(model, images, gen):
    """Set every BN's running stats from one forward pass over ``images``,
    layer by layer, then randomize them (mean + N(0, 0.2) std, var x
    U(0.5, 1.5)): activations keep a trained network's O(1) scale through
    all 20 layers (at the plain random init they shrink towards the biases)
    and the folding is non-trivial.  The pass runs the blocks' unfused
    epilogue: the fused kernel reads the statistics without calling the BN
    module, whose hook sets them."""
    from unittest import mock

    from odc_tpu_torch.models.layers import ConvBnLeaky, TorchBatchNorm

    def set_stats(bn, args):
        x = args[0].float().reshape(-1, args[0].shape[-1])
        n = x.shape[1]
        mean, var = x.mean(0), x.var(0)
        jitter = torch.randn(n, generator=gen).to(x.device)
        scale = (0.5 + torch.rand(n, generator=gen)).to(x.device)
        bn.running_mean.copy_(mean + 0.2 * jitter * var.sqrt())
        bn.running_var.copy_(var * scale)

    hooks = [m.register_forward_pre_hook(set_stats)
             for m in model.modules() if isinstance(m, TorchBatchNorm)]
    with torch.no_grad(), mock.patch.object(
            ConvBnLeaky, "_fuses_epilogue", lambda self, x: False):
        model(images)
    for h in hooks:
        h.remove()


def _bf16_ulp(x: torch.Tensor) -> float:
    """One bf16 ulp at the largest magnitude of ``x``."""
    mx = float(x.abs().max())
    return 2.0 ** (int(torch.tensor(mx).log2().floor()) - 7)


def phase_superstem():
    """Kernel vs plain superstem on the card at the main path's shape, and
    at odd sizes and in f32; the unfused cuDNN stem as the yardstick."""
    from odc_tpu_torch.models.layers import (
        ConvBnLeaky, imagenet_normalize, max_pool_2x2,
    )
    from odc_tpu_torch.ops.cuda.superstem_kernel import (
        fold_weights, superstem, superstem_plain,
    )

    gen = torch.Generator().manual_seed(SEED + 2)
    blocks = [ConvBnLeaky(3, 32, dtype=torch.bfloat16, generator=gen),
              ConvBnLeaky(32, 64, dtype=torch.bfloat16, generator=gen)]
    stem = torch.nn.Sequential(*blocks)
    _randomize_bn(stem, gen)
    stem.to(DEVICE).eval()
    args = []
    for blk in blocks:
        args += [blk.conv.weight, blk.conv.bias, blk.bn.weight, blk.bn.bias,
                 blk.bn.running_mean, blk.bn.running_var]
    with torch.no_grad():
        w1, w2 = fold_weights(*args, dtype=torch.bfloat16)
        f1, f2 = fold_weights(*args, dtype=torch.float32)

    def unfused(x):
        h = imagenet_normalize(x, torch.bfloat16)
        return max_pool_2x2(blocks[1](max_pool_2x2(blocks[0](h))))

    # The main path's shape, odd sizes, and edge cases of the bf16 route's
    # 8 x 16 output tiles: maps smaller than one tile (4x4 -> 1x1), and
    # rows and columns that leave the last tile partly empty (52x60 ->
    # 13x15).
    worst = 0.0
    for b, (h, w) in ((BATCH, HW), (3, (30, 45)), (2, (100, 132)),
                      (2, (4, 4)), (2, (52, 60)), (3, (7, 9))):
        x = torch.randint(0, 256, (b, h, w, 3), generator=gen,
                          dtype=torch.uint8).to(DEVICE)
        with torch.no_grad():
            got = superstem(x, w1, w2)
            ref = superstem_plain(x, w1, w2)
            sync()
            diff = (got.float() - ref.float()).abs()
            err = float(diff.max())
            n_diff = int((diff > 0).sum())
            tol = _bf16_ulp(ref.float())
            if got.shape != ref.shape or not err <= tol:
                raise AssertionError(
                    f"superstem bf16 {b}x{h}x{w}: err {err} > 1 ulp {tol}"
                )
            ref32 = superstem_plain(x[:2], f1, f2)
            err32 = float((superstem(x[:2], f1, f2) - ref32).abs().max())
            tol32 = 1e-5 * float(ref32.abs().max())  # f32 summation order
            if not err32 <= tol32:
                raise AssertionError(f"superstem f32 {h}x{w}: err {err32}")
            lib_err = float((unfused(x).float() - ref.float()).abs().max())
        print(f"superstem {b}x{h}x{w}: bf16 (tensor cores) max |kernel - "
              f"plain| {err} (bound 1 ulp = {tol}) in {n_diff} of "
              f"{diff.numel()} values, f32 {err32:.2e} (bound {tol32:.2e}), "
              f"unfused cuDNN stem vs plain {lib_err}")
        if (h, w) == HW:
            worst = err
            x_main = x

    with torch.no_grad():
        ms = time_ms(lambda: superstem(x_main, w1, w2), 20)
        plain_ms = time_ms(lambda: superstem_plain(x_main, w1, w2), 5)
        library_ms = time_ms(lambda: unfused(x_main), 20)
    h, w = HW
    flops = BATCH * (h * w * 32 * 27 * 2 + (h // 2) * (w // 2) * 64 * 288 * 2)
    nbytes = (BATCH * (h * w * 3 + (h // 4) * (w // 4) * 64 * 2)
              + 2 * (w1.numel() + w2.numel()))
    bms, by = bound_ms(nbytes, flops, BF16_FLOPS)
    print(f"superstem B={BATCH} {h}x{w} bf16: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, unfused cuDNN {library_ms:.3f} ms, bound "
          f"{bms:.4f} ms ({by}; {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)"
          f"; kernel at {100 * bms / ms:.1f}% of its bound")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "max_abs_err": worst, "library_ms": library_ms}


def _gap_threshold(conf: torch.Tensor, lo: int, hi: int) -> float:
    """Midpoint of the largest gap between adjacent sorted confidences
    between ranks ``lo`` and ``hi``: no candidate sits near it."""
    s = conf.flatten().double().sort(descending=True).values
    hi = min(hi, s.numel() - 1)
    r = lo + int((s[lo:hi] - s[lo + 1:hi + 1]).argmax())
    return float((s[r] + s[r + 1]) / 2)


def _epilogue_call(name, batch, hw=HW):
    """One ``make_infer_fn`` call of ``name`` (calibrated, bf16, ``hw``)
    at ``batch`` in which every conv block's output (the fused kernel's)
    is held bitwise against the same block run on the unfused route from
    the same input.  Returns each epilogue kernel's launches in the call,
    by name (``bias_bn_leaky`` and ``bias_bn_mish``, each held to the
    call's blocks of its activation), and, per distinct block output shape
    and activation, [count a call, the block, its output, its input]."""
    from unittest import mock

    from odc_tpu_torch.models.layers import ConvBnLeaky
    from odc_tpu_torch.models.yolov2 import YOLOv2
    from odc_tpu_torch.models.yolov3 import YOLOv3
    from odc_tpu_torch.models.yolov4 import YOLOv4
    from odc_tpu_torch.ops.cuda.bias_bn_leaky_kernel import bias_bn_leaky
    from odc_tpu_torch.ops.cuda.bias_bn_mish_kernel import bias_bn_mish
    from odc_tpu_torch.ops.detect import make_infer_fn

    cls = {"YOLOv2": YOLOv2, "YOLOv3": YOLOv3, "YOLOv4": YOLOv4}[name]
    model = cls(dtype=torch.bfloat16, device=DEVICE, seed=SEED,
                image_size=hw).eval()
    gen = torch.Generator().manual_seed(SEED + 11)
    images = torch.randint(0, 256, (batch, *hw, 3), generator=gen,
                           dtype=torch.uint8).to(DEVICE)
    _calibrate_bn(model, images[:8], gen)
    infer = make_infer_fn(model, 0.9, 0.5, MAX_KEEP)
    shapes, bad = {}, []

    def check(block, args, out):
        with mock.patch.object(ConvBnLeaky, "_fuses_epilogue",
                               lambda self, x: False):
            ref = block.forward(args[0])
        if not torch.equal(out, ref):
            bad.append((tuple(out.shape), int((out != ref).sum())))
        entry = shapes.setdefault((tuple(out.shape), block.activation),
                                  [0, block, out, args[0]])
        entry[0] += 1

    hooks = [m.register_forward_hook(check) for m in model.modules()
             if isinstance(m, ConvBnLeaky)]
    kernels = {"leaky": bias_bn_leaky, "mish": bias_bn_mish}
    try:
        before = {a: k.launches for a, k in kernels.items()}
        with torch.no_grad():
            infer(images)
        sync()
        launches = {a: k.launches - before[a] for a, k in kernels.items()}
    finally:
        for h in hooks:
            h.remove()
    if bad:
        raise AssertionError(f"{name}: fused epilogue != unfused route at "
                             f"(shape, differing elements) {bad}")
    blocks = {a: sum(e[0] for (_, act), e in shapes.items() if act == a)
              for a in kernels}
    if launches != blocks:
        raise AssertionError(f"{name}: kernel launches {launches} for "
                             f"blocks {blocks}")
    print(f"{name} b{batch}: {sum(blocks.values())} blocks, {len(shapes)} "
          f"shapes, every one bitwise the unfused route; launches a call "
          f"{launches}")
    return {f"bias_bn_{a}": n for a, n in launches.items()}, shapes


def phase_bias_bn_leaky():
    """The conv blocks' fused inference epilogue (bias + BN + leaky + bf16
    cast, ``csrc/bias_bn_leaky.cu``) at the bulk cells' shapes: YOLOv2-416
    at batch 64 and YOLOv3-416 at batch 256, every block of a call bitwise
    the unfused route; then, per call, the kernel's device ms (a CUDA graph
    a shape) beside its bound (4 bytes an element at HBM bandwidth) and the
    plain version's (ATen's separate passes)."""
    from odc_tpu_torch.ops.cuda.bias_bn_leaky_kernel import (
        bias_bn_leaky, bias_bn_leaky_plain,
    )

    out = {}
    for name, batch in (("YOLOv2", BATCH), ("YOLOv3", V3_BATCH)):
        launches, shapes = _epilogue_call(name, batch)
        ms = plain_ms = bound = 0.0
        for (shape, _), (n, block, y, _) in sorted(shapes.items()):
            bn = block.bn
            args = (block.conv.bias, bn.running_mean, bn.running_var,
                    bn.weight, bn.bias, bn.eps, block.negative_slope)
            y = y.contiguous()
            k_ms = graph_ms(lambda: bias_bn_leaky(y, *args), 3)
            p_ms = graph_ms(lambda: bias_bn_leaky_plain(y, *args), 1)
            b_ms = 4 * y.numel() / HBM_BPS * 1e3
            ms, plain_ms, bound = ms + n * k_ms, plain_ms + n * p_ms, bound + n * b_ms
            print(f"  {shape} x{n}: kernel {k_ms:.4f} ms, bound {b_ms:.4f} "
                  f"({100 * b_ms / k_ms:.1f}%), plain {p_ms:.4f}")
        del shapes
        torch.cuda.empty_cache()
        print(f"{name} b{batch} a call: kernel {ms:.3f} ms, bound {bound:.3f} "
              f"ms (bytes, {100 * bound / ms:.1f}%), plain {plain_ms:.3f} ms")
        out[name] = {"ms": ms, "bound_ms": bound, "plain_ms": plain_ms,
                     "launches_per_call": launches["bias_bn_leaky"]}
    return out


def phase_yolov4():
    """YOLOv4-608 (CSPDarknet53-Mish, SPP, PANet) at the bulk cell's batch
    of 64: every block of a ``make_infer_fn`` call (72 Mish, 35 leaky)
    bitwise the unfused route, one epilogue launch a block; the Mish
    epilogue alone at each of the call's Mish shapes (a CUDA graph a
    shape) beside its bound (4 bytes an element) and the plain version's
    time, with the elements where kernel and plain version differ counted;
    then ``make_infer_fn`` on the benchmark's seeded, calibrated weights
    against the plain f32 reference's decoded candidates (TF32 off) at a
    gap threshold, judged as the bulk cell judges (``reference/yolov4.py``):
    every number within the cell's limits, 1 NMS launch a call."""
    import types as _types

    from benchmark import harness
    from benchmark.reference import calibrate as bcal
    from odc_tpu_torch.ops.cuda.bias_bn_mish_kernel import (
        bias_bn_mish, bias_bn_mish_plain, mish_mismatches,
    )
    from odc_tpu_torch.ops.cuda.nms_kernel import suppress
    from odc_tpu_torch.ops.detect import make_infer_fn

    hw = (608, 608)
    launches, shapes = _epilogue_call("YOLOv4", BATCH, hw)
    if launches != {"bias_bn_leaky": 35, "bias_bn_mish": 72}:
        raise AssertionError(f"YOLOv4: epilogue launches {launches}, not 35 "
                             f"leaky and 72 Mish")
    ms = plain_ms = bound = 0.0
    differ = elements = 0
    for (shape, act), (n, block, _, inp) in sorted(shapes.items()):
        if act != "mish":
            continue
        bn = block.bn
        args = (block.conv.bias, bn.running_mean, bn.running_var, bn.weight,
                bn.bias, bn.eps)
        # The block's conv output without its bias: the kernel's input.
        with torch.no_grad():
            x = block._conv_nhwc(inp.to(torch.bfloat16),
                                 block.conv.weight.to(torch.bfloat16),
                                 None).contiguous()
        got, want = bias_bn_mish(x, *args), bias_bn_mish_plain(x, *args)
        d = int((got.view(torch.int16) != want.view(torch.int16)).sum())
        differ, elements = differ + n * d, elements + n * x.numel()
        k_ms = graph_ms(lambda: bias_bn_mish(x, *args), 3)
        p_ms = graph_ms(lambda: bias_bn_mish_plain(x, *args), 1)
        b_ms = 4 * x.numel() / HBM_BPS * 1e3
        ms, plain_ms, bound = ms + n * k_ms, plain_ms + n * p_ms, bound + n * b_ms
        print(f"  mish {shape} x{n}: kernel {k_ms:.4f} ms, bound {b_ms:.4f} "
              f"({100 * b_ms / k_ms:.1f}%), plain {p_ms:.4f}, {d} of "
              f"{x.numel()} elements differ")
        del x, got, want
    del shapes
    torch.cuda.empty_cache()
    print(f"YOLOv4 b{BATCH} Mish epilogue a call: kernel {ms:.3f} ms, bound "
          f"{bound:.3f} ms (bytes, {100 * bound / ms:.1f}%), plain "
          f"{plain_ms:.3f} ms; {differ} of {elements} elements differ from "
          f"the plain version")
    if differ:
        raise AssertionError(f"bias_bn_mish: {differ} elements differ")
    every = mish_mismatches(DEVICE)
    print(f"the kernel's Mish against F.mish, cast to bf16, over all 2^32 f32 "
          f"inputs: {every[0]} differ ({every[1]} of them NaN inputs)")
    if every[0]:
        raise AssertionError(f"bias_bn_mish: Mish differs at {every} inputs")

    cell = harness.load_json("workloads", "yolov4-608.bulk-b64")
    cfg = harness.load_json("configs", cell["config"])
    driver = harness.load_module("drivers", cell["driver"])
    t = dict(cell["mix"])
    ctx = _types.SimpleNamespace(cell=cell, cfg=cfg, seed=2**31 + 101,
                                 device=DEVICE, mark=lambda name: None)
    sd = driver.prepare(ctx)
    n = 16
    images = driver.make_images(n, hw, 2**31 + 102, DEVICE).cpu()
    ref = driver.reference_candidates(cfg, sd, images, t["reference_block"])
    thr = bcal.gap_threshold(ref.conf, t["keep_lo"] * n, t["keep_hi"] * n)
    del ref
    torch.cuda.empty_cache()
    model = driver.program_model(cfg, sd, DEVICE)
    infer = make_infer_fn(model, thr, t["iou_thre"], t["max_keep"], compact=True)
    before = suppress.launches
    out = [o.cpu() for o in infer(images.to(DEVICE))]
    nms_launches = suppress.launches - before
    del model, infer
    torch.cuda.empty_cache()
    numbers = driver.judge_calls(cfg, sd, [images], [out], thr, t)
    print(f"YOLOv4 b{n} make_infer_fn vs the plain reference: "
          + ", ".join(f"{k} {numbers[k]:.4g} (limit {v})"
                      for k, v in cell["limits"].items())
          + f"; served {numbers['served']:.0f}, reference "
          f"{numbers['reference']:.0f}; {nms_launches} NMS launch a call")
    over = {k: numbers[k] for k, v in cell["limits"].items() if numbers[k] > v}
    if over or nms_launches != 1:
        raise AssertionError(f"YOLOv4 against the reference: {over}, "
                             f"{nms_launches} NMS launches")
    return {"ms": ms, "bound_ms": bound, "plain_ms": plain_ms,
            "launches_per_call": launches["bias_bn_mish"],
            "elements_differing": differ,
            "f32_inputs_differing": every[0]}


def phase_graph():
    """A whole ``make_infer_fn`` call replayed as one CUDA graph, at each
    bulk cell's model, seeded weights and batch: three distinct batches
    cycled through ``3 + TIMED_CALLS`` calls eagerly (a no-op forward hook
    keeps a call eager) and then graphed (eager warm-up, capture, replays),
    outputs back on the host each call.  Every graphed call's outputs
    against the eager call's on the same batch (differing elements, 0
    required), each kernel's launches a call equal, one capture and a replay
    for every call after the second; the median ms a call of the last
    ``TIMED_CALLS`` both ways."""
    import types as _types

    from benchmark import harness
    from benchmark.reference import calibrate as bcal
    from odc_tpu_torch.ops.cuda import build
    from odc_tpu_torch.ops.detect import make_infer_fn

    calls = 3 + TIMED_CALLS
    res, bad = {}, []
    for name in ("yolov2-416.bulk-b64", "yolov3-416.bulk-b256",
                 "yolov4-608.bulk-b64"):
        cell = harness.load_json("workloads", name)
        cfg = harness.load_json("configs", cell["config"])
        driver = harness.load_module("drivers", cell["driver"])
        t = cell["mix"]
        ctx = _types.SimpleNamespace(cell=cell, cfg=cfg, seed=2**31 + 201,
                                     device=DEVICE, mark=lambda name: None)
        model = driver.program_model(cfg, driver.prepare(ctx), DEVICE)
        hw, n = tuple(cfg["image_size"]), t["batch"]
        batches = [driver.make_images(n, hw, 2**31 + 202 + i, DEVICE)
                   for i in range(3)]
        with torch.no_grad():
            conf = model.decode(model(batches[0][:16]), hw).conf
        thr = bcal.gap_threshold(conf, t["keep_lo"] * 16, t["keep_hi"] * 16)
        del conf
        infer = make_infer_fn(model, thr, t["iou_thre"], t["max_keep"],
                              compact=True)

        def run():
            outs, ms, launches = [], [], set()
            for i in range(calls):
                before = [k.launches for k in build.COUNTED]
                t0 = time.perf_counter()
                outs.append([o.cpu() for o in infer(batches[i % 3])])
                ms.append((time.perf_counter() - t0) * 1e3)
                launches.add(tuple(k.launches - b
                                   for k, b in zip(build.COUNTED, before)))
            return outs, statistics.median(ms[-TIMED_CALLS:]), launches

        hook = model.register_forward_pre_hook(lambda *a: None)
        eager, eager_ms, eager_launches = run()
        hook.remove()
        if (infer.graph_captures, infer.graph_replays) != (0, 0):
            bad.append(f"{name}: a hooked call was graphed")
        graphed, graphed_ms, graphed_launches = run()
        differ = sum(int((a != b).sum()) for g, e in zip(graphed, eager)
                     for a, b in zip(g, e))
        counts = (infer.graph_captures, infer.graph_replays)
        row = {"differing_elements": differ,
               "elements": sum(a.numel() for g in graphed for a in g),
               "eager_ms": eager_ms, "graphed_ms": graphed_ms,
               "graph_captures": counts[0], "graph_replays": counts[1],
               "launches_a_call": {
                   k.__name__: n for k, n in zip(
                       build.COUNTED, sorted(graphed_launches)[0]) if n},
               "kept": int(sum(int(g[-1].sum()) for g in graphed))}
        print(f"{name} graphed vs eager: {differ} of {row['elements']} "
              f"elements differ; ms a call {graphed_ms:.3f} graphed, "
              f"{eager_ms:.3f} eager; captures {counts[0]}, replays "
              f"{counts[1]}; launches a call {row['launches_a_call']}")
        if differ or counts != (1, calls - 2) or row["kept"] == 0:
            bad.append(f"{name}: {row}")
        if len(eager_launches) != 1 or graphed_launches != eager_launches:
            bad.append(f"{name}: launches a call {graphed_launches} graphed, "
                       f"{eager_launches} eager")
        res[name] = row
        del model, infer, batches, eager, graphed
        torch.cuda.empty_cache()
    print(json.dumps({"phase": "graph", **res}))
    if bad:
        raise AssertionError("graph: " + "; ".join(bad))
    return res


def phase_e2e():
    """The main path: YOLOv2-416 bf16, a few batches through make_infer_fn."""
    from odc_tpu_torch.core.nms import sorted_candidates
    from odc_tpu_torch.models.layers import ConvBnLeaky
    from odc_tpu_torch.models.yolov2 import YOLOv2
    from odc_tpu_torch.ops.cuda.bias_bn_leaky_kernel import bias_bn_leaky
    from odc_tpu_torch.ops.cuda.nms_kernel import suppress, suppress_plain
    from odc_tpu_torch.ops.cuda.superstem_kernel import (
        superstem, superstem_plain,
    )
    from odc_tpu_torch.ops.detect import make_infer_fn, stem_weights

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 4)
    requests = [
        torch.randint(0, 256, (b, *HW, 3), generator=gen, dtype=torch.uint8)
        .to(DEVICE)
        for b in (8, BATCH)
    ]
    model = YOLOv2(dtype=torch.bfloat16, device=DEVICE, seed=SEED).eval()
    _calibrate_bn(model, requests[0], torch.Generator().manual_seed(SEED + 3))
    infer = make_infer_fn(model, 0.9, 0.5, MAX_KEEP)
    # The product threshold 0.9 may keep nothing under random weights, so
    # the first request is also answered at a runtime conf placed in the
    # largest gap of its candidates' confs (8 to 48 survivors per image),
    # taken from the unfused model, which launches neither kernel.
    with torch.no_grad():
        conf0 = model.decode(model(requests[0]), HW).conf
    n0 = requests[0].shape[0]
    gap_thre = _gap_threshold(conf0, 8 * n0, 48 * n0)
    sync()
    print(f"model built, BN calibrated, weights folded in "
          f"{time.perf_counter() - t0:.1f} s")

    calls = ([(requests[0], 0.9), (requests[0], gap_thre)]
             + [(requests[1], 0.9)] * (3 + TIMED_CALLS))
    # The fused stem runs stages 1-2; every other block fuses its epilogue.
    blocks = sum(isinstance(m, ConvBnLeaky) for m in model.modules()) - sum(
        len(stage) for stage in model.backbone.stages[:2])
    superstem.launches = suppress.launches = bias_bn_leaky.launches = 0
    outs, call_ms = [], []
    for i, (images, conf_thre) in enumerate(calls):
        before = (superstem.launches, suppress.launches, bias_bn_leaky.launches)
        t = time.perf_counter()
        out = infer(images, conf_thre=conf_thre)
        sync()
        if i >= len(calls) - TIMED_CALLS:
            call_ms.append((time.perf_counter() - t) * 1e3)
        if (superstem.launches, suppress.launches) != (before[0] + 1, before[1] + 1):
            raise AssertionError(f"call {i}: kernels did not launch once each")
        if bias_bn_leaky.launches - before[2] != blocks:
            raise AssertionError(f"call {i}: the fused epilogue did not "
                                 f"launch once for each of {blocks} blocks")
        if i < 3:
            outs.append((images, conf_thre, out))
    launches = {"superstem": superstem.launches,
                "nms_suppress": suppress.launches,
                "bias_bn_leaky": bias_bn_leaky.launches}
    print(f"main path: {len(calls)} calls, launches {launches}")

    for images, conf_thre, (boxes, conf, cls, keep) in outs:
        b = images.shape[0]
        if not (boxes.shape == (b, MAX_KEEP, 4) and conf.shape == (b, MAX_KEEP)
                and cls.shape == (b, MAX_KEEP, model.num_cls)
                and keep.shape == (b, MAX_KEEP)):
            raise AssertionError("unexpected output shapes")
        if not all(bool(torch.isfinite(t).all()) for t in (boxes, conf, cls)):
            raise AssertionError("non-finite outputs")
        if bool((conf[keep] < conf_thre).any()):
            raise AssertionError("a kept box is below the conf threshold")
        print(f"batch {b} at conf {conf_thre:.6f}: kept per image "
              f"{keep.sum(1).tolist()[:16]}{' ...' if b > 16 else ''}")
    if not bool(outs[1][2][3].any()):
        raise AssertionError("the gap threshold kept no box")

    med = statistics.median(call_ms)
    q = statistics.quantiles(call_ms, n=4)
    img_s = BATCH / med * 1e3
    print(f"YOLOv2-416 bf16 e2e, batch {BATCH}, images on the card: median "
          f"{med:.3f} ms/call (quartiles {q[0]:.3f} / {q[2]:.3f}, n="
          f"{len(call_ms)}) -> {img_s:.1f} img/s")

    # Stem: superstem + input handling; backbone: Darknet-19 stages 3-7;
    # head: the 1x1 conv + reshape.
    _layer_breakdown(infer, requests[1], [
        (model, "pre", "stem"), (model.backbone, "post", "backbone"),
        (model.neck, "post", "neck"), (model, "post", "head")])
    _profile(lambda: infer(requests[1]))

    # Head output: fused stem vs plain stem on the same bf16 model.  Bound:
    # the model's own bf16 rounding noise n = max |y_bf16 - y_f32| (plain
    # stem, against an f32 copy).  Both bf16 runs differ only by where
    # rounding falls, so each lies about n from the f32 output and they
    # lie within 2n of each other.
    images = requests[1][:16]
    w1, w2 = stem_weights(model)
    model32 = YOLOv2(dtype=torch.float32, device=DEVICE, seed=SEED)
    model32.load_state_dict(model.state_dict())
    model32.eval()
    with torch.no_grad():
        y_fused = model(images, stem_out=superstem(images, w1, w2))
        y_plain = model(images, stem_out=superstem_plain(images, w1, w2))
        y_f32 = model32(images)
    err = float((y_fused - y_plain).abs().max())
    noise = float((y_plain - y_f32).abs().max())
    fused_noise = float((y_fused - y_f32).abs().max())
    print(f"head [16,13,13,5,25]: max |fused - plain stem| {err:.4f} (bound "
          f"2n = {2 * noise:.4f}); n = max |bf16 - f32| {noise:.4f} with the "
          f"plain stem, {fused_noise:.4f} with the fused; |y| max "
          f"{float(y_plain.abs().max()):.3f}")
    if not err <= 2 * noise:
        raise AssertionError("fused stem moved the head beyond bf16 noise")

    # NMS on the main path's own candidates: kernel == plain, at the
    # product threshold and at one placed in the largest conf gap.
    det = model.decode(y_fused, HW)
    boxes = det.boxes.reshape(images.shape[0], -1, 4)
    conf = det.conf.reshape(images.shape[0], -1)
    kept = []
    # 8 to 48 survivors per image on average: suppression has work to do.
    n_img = conf.shape[0]
    for thr in (0.9, _gap_threshold(conf, 8 * n_img, 48 * n_img)):
        _, cand, surv = sorted_candidates(boxes, conf, conf >= thr, MAX_KEEP)
        keep = suppress(cand, surv, 0.5)
        if not torch.equal(keep, suppress_plain(cand, surv, 0.5)):
            raise AssertionError(f"NMS kernel != plain on e2e candidates, {thr}")
        kept.append(int(keep.sum()))
        print(f"e2e candidates, conf {thr:.6f}: {int(surv.sum())} survivors, "
              f"{kept[-1]} kept over {n_img} images (kernel == plain)")
    print(f"conf range [{float(conf.min()):.6f}, {float(conf.max()):.6f}]")
    if kept[0] == 0:
        print("the product threshold 0.9 keeps nothing under random weights; "
              "the gap threshold above exercises suppression")
    return launches, img_s, model, requests


def _layer_breakdown(infer, images, points, iters: int = 10):
    """Device time per part of one infer call, from CUDA events recorded by
    module hooks: ``points`` lists ``(module, "pre" or "post", name)``, each
    name the part that ends at that point; the part after the last point
    is decode + NMS."""
    marks = []

    def mark(name):
        def hook(*_):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))
        return hook

    hooks = [
        module.register_forward_pre_hook(mark(name)) if when == "pre"
        else module.register_forward_hook(mark(name))
        for module, when, name in points
    ]
    totals = {}
    try:
        for it in range(iters + 2):
            marks.clear()
            mark("start")()
            infer(images)
            mark("decode+nms")()
            sync()
            if it < 2:
                continue
            for (_, a), (name, b) in zip(marks, marks[1:]):
                totals[name] = totals.get(name, 0.0) + a.elapsed_time(b) / iters
    finally:
        for h in hooks:
            h.remove()
    total = sum(totals.values())
    print(f"layer breakdown, batch {images.shape[0]}, device ms per call "
          f"(CUDA events, {iters} calls): " + ", ".join(
              f"{k} {v:.3f} ({100 * v / total:.1f}%)" for k, v in totals.items()))


def _profile(fn, calls: int = 3, also=()):
    """torch.profiler over a few calls of ``fn()``: device busy share, the
    kernels that take the most device time, and any kernel whose name
    contains one of ``also``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        sync()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):  # kernels
            dev_us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
            rows.append((dev_us / 1e3 / calls, e.key, e.count // calls))
    busy = sum(r[0] for r in rows) * calls
    if not rows:
        print("profiler: no device time recorded")
        return None
    print(f"profiler, {calls} calls: device busy {busy:.3f} of {wall_ms:.3f} "
          f"ms wall ({100 * busy / wall_ms:.1f}%); top kernels, ms per call:")
    ranked = sorted(rows, reverse=True)
    for i, (ms, key, n) in enumerate(ranked):
        if i < 12 or any(name in key for name in also):
            print(f"  {ms:8.3f}  x{n:<4d} {key[:90]}")
    return 100 * busy / wall_ms


def _mm_bound(m: int, k: int, n: int, elem: int, out: int):
    """(bytes, operations) a product [m, k] @ [k, n] must move and do:
    each operand read once, the result written once."""
    return (m * k + k * n) * elem + m * n * out, 2.0 * m * k * n


def phase_matmul():
    """Kernel vs plain GEMM on the card: the TPU probe's four shapes at
    batch 64 (M = 64 * 169), the engine's largest A (stage 2) and a ragged
    shape, int8 (bitwise, and bitwise against ``torch._int_mm``) and bf16
    (f32 summation bound), with times in a CUDA graph."""
    from odc_tpu_torch.ops.cuda.matmul_kernel import (
        matmul, matmul_plain, route,
    )

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    m13 = BATCH * 169
    shapes = [("13grid 3x3 1024->1024", m13, 9216, 1024),
              ("13grid 3x3  512->1024", m13, 4608, 1024),
              ("13grid 1x1 1024-> 512", m13, 1024, 512),
              ("26grid 3x3  256-> 512", 4 * m13, 2304, 512),
              ("stage 2 3x3 32->64 at 208", BATCH * 208 * 208, 288, 64),
              ("ragged", 1000, 300, 70)]
    for name, m, k, n in shapes:
        a = torch.randint(-128, 128, (m, k), generator=gen, device=DEVICE,
                          dtype=torch.int8)
        bt = torch.randint(-127, 128, (n, k), generator=gen, device=DEVICE,
                           dtype=torch.int8)
        b = bt.t()
        path = route(m, n, k, a.dtype, a, b)
        want = "mma_sync" if name == "ragged" else "wgmma"
        if path != want:
            raise AssertionError(f"matmul int8 {name}: route {path}, "
                                 f"expected {want}")
        before = dict(matmul.launches_by_route)
        got, ref = matmul(a, b), matmul_plain(a, b)
        sync()
        if matmul.launches_by_route[path] != before[path] + 1:
            raise AssertionError(f"matmul int8 {name}: no {path} launch")
        if not torch.equal(got, ref):
            raise AssertionError(f"matmul int8 {name}: kernel != plain")
        lib = "n/a (_int_mm needs K, N multiples of 8)"
        lib_ms = None
        if k % 8 == 0 and n % 8 == 0:
            if not torch.equal(torch._int_mm(a, b), ref):
                raise AssertionError(f"matmul int8 {name}: kernel != _int_mm")
            lib_ms = graph_ms(lambda: torch._int_mm(a, b), 5)
            lib = f"{lib_ms:.4f} ms"
        ms = graph_ms(lambda: matmul(a, b), 5)
        older = ""
        if path == "wgmma":  # the mma.sync route on the same operands
            if not torch.equal(matmul(a, b, path="mma_sync"), ref):
                raise AssertionError(f"matmul int8 {name}: mma_sync != plain")
            old_ms = graph_ms(lambda: matmul(a, b, path="mma_sync"), 5)
            older = f", mma_sync route {old_ms:.4f} ms"
        plain_ms = time_ms(lambda: matmul_plain(a, b), 3, warmup=1)
        nbytes, ops = _mm_bound(m, k, n, 1, 4)
        bms, by = bound_ms(nbytes, ops, INT8_OPS)
        print(f"matmul int8 {name} M={m} K={k} N={n}, route {path}: bitwise "
              f"equal to plain{' and _int_mm' if lib_ms is not None else ''};"
              f" kernel {ms:.4f} ms ({ops / ms / 1e9:.1f} TOPS){older}, plain "
              f"{plain_ms:.3f} ms, _int_mm {lib}, bound {bms:.4f} ms ({by})")
        del a, bt, b, got, ref

        a = torch.randn(m, k, generator=gen, device=DEVICE).bfloat16()
        bt = torch.randn(n, k, generator=gen, device=DEVICE).bfloat16()
        b = bt.t()
        got, ref = matmul(a, b), matmul_plain(a, b)
        # f32 summation over K terms: |err| <= K * 2**-24 * (|a| @ |b|).
        tol = k * 2.0 ** -24 * (a.float().abs() @ b.float().abs())
        err = (got - ref).abs()
        rel = float((err / (a.float().abs() @ b.float().abs())
                     .clamp_min(1e-30)).max())
        if not bool((err <= tol).all()):
            raise AssertionError(f"matmul bf16 {name}: beyond the f32 bound")
        ms = graph_ms(lambda: matmul(a, b), 5)
        lib_ms = graph_ms(lambda: torch.matmul(a, b), 5)
        nbytes, ops = _mm_bound(m, k, n, 2, 4)
        bms, by = bound_ms(nbytes, ops, BF16_FLOPS)
        print(f"matmul bf16 {name}: max |kernel - plain| {float(err.max()):.3e}"
              f" ({rel:.2e} of |a| @ |b|; bound K * 2^-24 = "
              f"{k * 2.0 ** -24:.2e}); kernel {ms:.4f} ms "
              f"({ops / ms / 1e9:.1f} TFLOP/s), torch.matmul (bf16 out) "
              f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")
        del a, bt, b, got, ref, tol, err


@contextlib.contextmanager
def _swap_matmul(fn):
    """Route the int8 convolutions' GEMM (``ops/quantize.py`` calls
    ``matmul_kernel.matmul``) through ``fn(real, a, b)``; the kernel module
    itself, and its launch count, stay as they are."""
    import types

    from odc_tpu_torch.ops import quantize

    real = quantize.matmul_kernel
    quantize.matmul_kernel = types.SimpleNamespace(
        matmul=lambda a, b: fn(real.matmul, a, b))
    try:
        yield
    finally:
        quantize.matmul_kernel = real


def phase_int8_e2e(model, requests, counters):
    """The int8 main path: calibrate on 32 images, then YOLOv2-416 through
    ``make_infer_fn(int8_scales=..., int8_stem='s2d')`` on the requests of
    phase_e2e; ``counters`` are the wrappers whose launch counts are zeroed
    just before the calls and read just after.  Then the checks on the
    card, the main path's own GEMMs against the plain version and
    ``torch._int_mm``, and the ``int8_neck`` path."""
    from odc_tpu_torch.models.yolov2 import YOLOv2
    from odc_tpu_torch.ops import int8_engine as te
    from odc_tpu_torch.ops.cuda.matmul_kernel import matmul_plain
    from odc_tpu_torch.ops.detect import make_infer_fn

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 10)
    calib = torch.randint(0, 256, (CALIB_IMAGES, *HW, 3), generator=gen,
                          dtype=torch.uint8).to(DEVICE)
    scales = te.calibrate(model, calib)  # TF32 is off (main)
    sync()
    print(f"int8: calibrated on {CALIB_IMAGES} images in "
          f"{time.perf_counter() - t0:.2f} s; ranges [22, 2] in "
          f"[{float(scales.min()):.4g}, {float(scales.max()):.4g}]")
    del calib
    infer = make_infer_fn(model, 0.9, 0.5, MAX_KEEP, int8_scales=scales,
                          int8_stem="s2d")
    with torch.no_grad():
        conf0 = model.decode(te.yolov2_int8_forward(
            model, requests[0], scales=scales, stem="s2d"), HW).conf
    n0 = requests[0].shape[0]
    gap_thre = _gap_threshold(conf0, 8 * n0, 48 * n0)

    calls = ([(requests[0], 0.9), (requests[0], gap_thre)]
             + [(requests[1], 0.9)] * (3 + TIMED_CALLS))
    mm = counters["int8_matmul"]
    for wrapper in counters.values():
        wrapper.launches = 0
    mm.launches_by_route = dict.fromkeys(mm.launches_by_route, 0)
    call_ms, outs = [], []
    for i, (images, conf_thre) in enumerate(calls):
        before = {k: w.launches for k, w in counters.items()}
        routes_before = dict(mm.launches_by_route)
        t = time.perf_counter()
        out = infer(images, conf_thre=conf_thre)
        sync()
        if i >= len(calls) - TIMED_CALLS:
            call_ms.append((time.perf_counter() - t) * 1e3)
        step = {k: w.launches - before[k] for k, w in counters.items()}
        if step != {"int8_matmul": 20, "nms_suppress": 1, "superstem": 0}:
            raise AssertionError(f"int8 call {i}: launches {step}")
        routes = {k: v - routes_before[k]
                  for k, v in mm.launches_by_route.items()}
        if routes != {"wgmma": 20, "mma_sync": 0}:
            raise AssertionError(f"int8 call {i}: GEMM routes {routes}")
        if i < 3:
            outs.append((images, conf_thre, out))
    launches = {k: w.launches for k, w in counters.items()}
    by_route = dict(mm.launches_by_route)
    print(f"main path (int8): {len(calls)} calls, launches {launches}, GEMM "
          f"launches by route {by_route}")
    for images, conf_thre, (boxes, conf, cls, keep) in outs:
        b = images.shape[0]
        if not (boxes.shape == (b, MAX_KEEP, 4) and keep.shape == (b, MAX_KEEP)
                and cls.shape == (b, MAX_KEEP, model.num_cls)):
            raise AssertionError("int8: unexpected output shapes")
        if not all(bool(torch.isfinite(t).all()) for t in (boxes, conf, cls)):
            raise AssertionError("int8: non-finite outputs")
        if bool((conf[keep] < conf_thre).any()):
            raise AssertionError("int8: a kept box is below the threshold")
        print(f"int8 batch {b} at conf {conf_thre:.6f}: kept per image "
              f"{keep.sum(1).tolist()[:16]}{' ...' if b > 16 else ''}")
    if not bool(outs[1][2][3].any()):
        raise AssertionError("int8: the gap threshold kept no box")
    med = statistics.median(call_ms)
    q = statistics.quantiles(call_ms, n=4)
    img_s = BATCH / med * 1e3
    print(f"YOLOv2-416 int8 PTQ e2e (s2d stem), batch {BATCH}, images on the "
          f"card: median {med:.3f} ms/call (quartiles {q[0]:.3f} / "
          f"{q[2]:.3f}, n={len(call_ms)}) -> {img_s:.1f} img/s")
    _profile(lambda: infer(requests[1]), also=("matmul_kernel",))

    images = requests[1]
    with torch.no_grad():
        y8 = te.yolov2_int8_forward(model, images, scales=scales, stem="s2d")
        with _swap_matmul(lambda real, a, b: matmul_plain(a, b)):
            y8_plain = te.yolov2_int8_forward(model, images, scales=scales,
                                              stem="s2d")
        if not torch.equal(y8, y8_plain):
            raise AssertionError("int8 head: kernel GEMMs != plain GEMMs")
        model32 = YOLOv2(dtype=torch.float32, device=DEVICE, seed=SEED)
        model32.load_state_dict(model.state_dict())
        model32.eval()
        y32 = model32(images)
        y16 = model(images)
    rng = float(y32.abs().max())
    err = float((y8 - y32).abs().max())
    mean_err = float((y8 - y32).abs().mean())
    print(f"int8 head [{BATCH},13,13,5,25]: bitwise equal with the kernel's "
          f"and the plain version's GEMMs; max |int8 - f32| {err:.4f} = "
          f"{100 * err / rng:.2f}% of the f32 head's range {rng:.3f} (PTQ "
          f"budget 6%), mean {mean_err:.5f}; bf16 model for scale: max "
          f"|bf16 - f32| {float((y16 - y32).abs().max()):.4f}")
    del y8_plain, y16, model32
    if not bool(torch.isfinite(y8).all()):
        raise AssertionError("int8 head: non-finite values")

    with torch.no_grad():
        s2d1 = te.yolov2_int8_forward(model, images, scales=scales,
                                      stem="s2d", stop_after=1)
        front1 = te.yolov2_int8_forward(model, images, scales=scales,
                                        bf16_front=1, stop_after=1)
        s2d2 = te.yolov2_int8_forward(model, images, scales=scales,
                                      stem="s2d2", stop_after=1)
        if not torch.equal(s2d2, te._pool(s2d1)):
            raise AssertionError("int8: stem s2d2 != pooled s2d codes")
    flips = (s2d1 != front1)
    print(f"int8 codes after conv1: s2d2 == pool(s2d) bitwise; s2d vs "
          f"bf16_front=1 (two cuDNN f32 convs of bf16 values) differ in "
          f"{int(flips.sum())} of {flips.numel()} codes, by at most "
          f"{int((s2d1.int() - front1.int()).abs().max())}")

    # The main path's own 20 GEMMs, recorded from one call.
    recorded = []

    def record(real, a, b):
        recorded.append((a, b))
        return real(a, b)

    with _swap_matmul(record), torch.no_grad():
        te.yolov2_int8_forward(model, images, scales=scales, stem="s2d")
    tot = dict(ms=0.0, older_ms=0.0, plain_ms=0.0, library_ms=0.0,
               bytes_ms=0.0, ops_ms=0.0, bound_ms=0.0)
    from odc_tpu_torch.ops.cuda.matmul_kernel import matmul, route
    for i, (a, b) in enumerate(recorded):
        m, k = a.shape
        n = b.shape[1]
        if route(m, n, k, a.dtype, a, b) != "wgmma":
            raise AssertionError(f"main-path GEMM {i}: not the wgmma route")
        got, ref = matmul(a, b), matmul_plain(a, b)
        older = matmul(a, b, path="mma_sync")
        if not (torch.equal(got, ref) and torch.equal(torch._int_mm(a, b), ref)
                and torch.equal(older, ref)):
            raise AssertionError(f"main-path GEMM {i}: kernel, plain, "
                                 f"mma_sync route and _int_mm disagree")
        del got, ref, older
        ms = graph_ms(lambda: matmul(a, b), 3)
        older_ms = graph_ms(lambda: matmul(a, b, path="mma_sync"), 3)
        plain_ms = time_ms(lambda: matmul_plain(a, b), 2, warmup=1)
        lib_ms = graph_ms(lambda: torch._int_mm(a, b), 3)
        nbytes, ops = _mm_bound(m, k, n, 1, 4)
        bms, by = bound_ms(nbytes, ops, INT8_OPS)
        for key, v in (("ms", ms), ("older_ms", older_ms),
                       ("plain_ms", plain_ms),
                       ("library_ms", lib_ms), ("bound_ms", bms),
                       ("bytes_ms", nbytes / HBM_BPS * 1e3),
                       ("ops_ms", ops / INT8_OPS * 1e3)):
            tot[key] += v
        print(f"  main-path GEMM {i:2d} M={m} K={k} N={n}: wgmma {ms:.4f} ms "
              f"({ops / ms / 1e9:.1f} TOPS), mma_sync {older_ms:.4f}, plain "
              f"{plain_ms:.3f}, _int_mm {lib_ms:.4f}, bound {bms:.4f} ({by})")
    del recorded
    print(f"main-path GEMMs ({BATCH} images, all 20 on the wgmma route): "
          f"kernel {tot['ms']:.3f} ms (mma_sync route "
          f"{tot['older_ms']:.3f}), plain {tot['plain_ms']:.3f}, _int_mm "
          f"{tot['library_ms']:.3f}, bound {tot['bound_ms']:.4f} ms "
          f"(operations {tot['ops_ms']:.4f}, bytes {tot['bytes_ms']:.4f}; "
          f"kernel at {100 * tot['bound_ms'] / tot['ms']:.1f}% of it); all "
          f"bitwise equal to plain and _int_mm")
    row = {"launches_by_route": by_route,
           "ms": tot["ms"], "plain_ms": tot["plain_ms"],
           "bound_ms": tot["bound_ms"],
           "bound_by": ("operations" if tot["ops_ms"] >= tot["bytes_ms"]
                        else "bytes"),
           "max_abs_err": 0.0, "library_ms": tot["library_ms"]}

    # The int8_neck path: fused stem, int8 neck.
    neck_infer = make_infer_fn(model, 0.9, 0.5, MAX_KEEP, int8_neck=True)
    neck_ms = []
    for i in range(3 + TIMED_CALLS // 2):
        before = {k: w.launches for k, w in counters.items()}
        routes_before = dict(mm.launches_by_route)
        t = time.perf_counter()
        neck_infer(requests[1])
        sync()
        if i >= 3:
            neck_ms.append((time.perf_counter() - t) * 1e3)
        step = {k: w.launches - before[k] for k, w in counters.items()}
        if step != {"int8_matmul": 1, "nms_suppress": 1, "superstem": 1}:
            raise AssertionError(f"int8_neck call {i}: launches {step}")
        if mm.launches_by_route["wgmma"] != routes_before["wgmma"] + 1:
            raise AssertionError(f"int8_neck call {i}: GEMM not on wgmma")
    print(f"YOLOv2-416 bf16 with the int8 neck, batch {BATCH}: median "
          f"{statistics.median(neck_ms):.3f} ms/call (n={len(neck_ms)}); "
          f"1 superstem, 1 GEMM, 1 NMS launch per call")
    return launches, img_s, row, scales


def _inverse_maps(hw, specs):
    """Inverse maps [N, 3, 3] f32 for ``specs``, dicts of scale, tx, ty
    (pixels), theta (degrees), fx, fy (flip signs): the augmentation's
    matrix family, inverted in float64."""
    from odc_tpu_torch.ops.augment import affine_matrices

    def col(key, default):
        return torch.tensor([float(sp.get(key, default)) for sp in specs],
                            dtype=torch.float64)

    ms = affine_matrices(
        col("scale", 1.0), col("tx", 0.0), col("ty", 0.0),
        torch.deg2rad(col("theta", 0.0)), col("fx", 1.0), col("fy", 1.0), hw,
    )
    return torch.linalg.inv(ms).float().contiguous()


def _shear_maps(hw, shear):
    """Inverse maps [12, 3, 3] f32 about the canvas center whose two pass
    slopes sit at the shift bound: q1 = b/d and c each +-``shear``, with no
    flip, a horizontal and a vertical flip."""
    h, w = hw
    cx, cy = (w - 1) / 2, (h - 1) / 2
    maps = []
    for q1 in (shear, -shear):
        for c in (shear, -shear):
            for sx, sy in ((1.0, 1.0), (-1.0, 1.0), (1.0, -1.0)):
                d = sy
                b = q1 * d
                a = sx + q1 * c  # p = a - q1*c = sx
                maps.append([[a, b, cx - a * cx - b * cy],
                             [c, d, cy - c * cx - d * cy], [0.0, 0.0, 1.0]])
    return torch.tensor(maps, dtype=torch.float32)


def _check_warp(warp_affine, warp_affine_plain, images, m_invs, max_shear,
                exact, tol, what):
    """Kernel (f32 and uint8 routes) vs plain on uint8-valued ``images``,
    the first ``exact`` images bitwise; returns the f32 route's output, the
    plain version's and their largest difference."""
    got = warp_affine(images, m_invs, max_shear)
    got_u8 = warp_affine(images.to(torch.uint8), m_invs, max_shear)
    ref = warp_affine_plain(images, m_invs, max_shear)
    sync()
    err = float((got - ref).abs().max())
    if got.shape != ref.shape or not err <= tol:
        raise AssertionError(f"warp {what}: max |kernel - plain| {err}")
    if not torch.equal(got[:exact], ref[:exact]):
        raise AssertionError(f"warp {what}: identity/flips not exact")
    if got_u8.dtype != torch.float32 or not torch.equal(got_u8, got):
        raise AssertionError(f"warp {what}: uint8 route != f32 route")
    return got, ref, err


def phase_warp():
    """Kernel vs plain two-pass warp on the card: the augmentation's corner
    cases at the training shape and at odd sizes; single images at 4x4,
    17x33 and 416x416 with C = 1..4, slopes at the shift bound with each
    flip and a shift that leaves whole tiles in the zero fill; the uint8
    route bitwise equal to the f32 route throughout; then a sampled batch
    of 32 at 416x416, which is also the timed shape."""
    import torch.nn.functional as F

    from odc_tpu_torch.ops.augment import (
        AugmentConfig, sample_augment_params, warp_max_shear,
    )
    from odc_tpu_torch.ops.cuda.warp_kernel import warp_affine, warp_affine_plain

    cfg = AugmentConfig()
    max_shear = warp_max_shear(cfg)
    gen = torch.Generator().manual_seed(SEED + 5)
    tol = 1e-3  # on 0..255: order of the final blends only (see the .cu)
    worst = 0.0
    for h, w in (HW, (30, 45), (100, 132)):
        specs = [dict(), dict(fx=-1), dict(fy=-1)]
        specs += [dict(theta=t, scale=sc) for t in (45, -45) for sc in (0.8, 1.2)]
        specs += [dict(tx=0.2 * w, ty=-0.2 * h), dict(tx=-0.2 * w, ty=0.2 * h)]
        m_invs = _inverse_maps((h, w), specs).to(DEVICE)
        # Pixels in 1..255: a zero in the output is zero fill.
        images = torch.randint(1, 256, (len(specs), h, w, 3), generator=gen)
        images = images.float().to(DEVICE)
        got, ref, _ = _check_warp(warp_affine, warp_affine_plain, images,
                                  m_invs, max_shear, 3, tol, f"{h}x{w}")
        errs = (got - ref).abs().amax(dim=(1, 2, 3)).tolist()
        # Content moved right by 20% and up by 20%: the vacated left band
        # and bottom band are exactly zero, the rest is not.
        band_x, band_y = int(0.2 * w) - 1, h - int(0.2 * h) + 1
        moved = got[7]
        if bool((moved[:, :band_x] != 0).any()) or bool((moved[band_y:] != 0).any()):
            raise AssertionError(f"warp {h}x{w}: vacated region not zero")
        if not bool((moved[: band_y - 2, band_x + 2:] != 0).all()):
            raise AssertionError(f"warp {h}x{w}: kept region holds zeros")
        same_fill = torch.equal(got == 0, ref == 0)
        print(f"warp {len(specs)}x{h}x{w} (identity, flips, +-45 deg at 0.8 "
              f"and 1.2, +-20% shifts): max |kernel - plain| "
              f"{max(errs):.3e} (bound {tol}), zero-fill masks identical: "
              f"{same_fill}; uint8 route bitwise equal to f32")
        worst = max(worst, max(errs))

    # One image at a time: identity and flips (exact), the 12 slope-bound
    # maps, and a shift by 60% of the size that leaves whole 32x32 tiles in
    # the zero fill, at every channel count the kernel takes.
    for h, w in ((4, 4), (17, 33), HW):
        maps = torch.cat([
            _inverse_maps((h, w), [dict(), dict(fx=-1), dict(fy=-1)]),
            _shear_maps((h, w), max_shear),
            _inverse_maps((h, w), [dict(tx=0.6 * w, ty=-0.6 * h)])])
        errs = []
        for ch in (1, 2, 3, 4):
            images = torch.randint(1, 256, (1, h, w, ch), generator=gen)
            images = images.float().to(DEVICE)
            for i, m_inv in enumerate(maps.to(DEVICE)):
                got, _, err = _check_warp(
                    warp_affine, warp_affine_plain, images, m_inv[None],
                    max_shear, int(i < 3), tol, f"1x{h}x{w}x{ch}")
                errs.append(err)
            if (h, w) == HW:
                far = got[0]  # the last map: the 60% shift
                tiles = far[:, : (int(0.6 * w) // 32) * 32]
                if tiles.numel() == 0 or bool((tiles != 0).any()):
                    raise AssertionError("warp: zero-fill tiles not zero")
        worst = max(worst, max(errs))
        print(f"warp 1x{h}x{w}, C = 1..4, {len(maps)}"
              f" maps each (identity and flips exact; slopes +-{max_shear:.3f}"
              f" with each flip; a 60% shift): max |kernel - plain| "
              f"{max(errs):.3e} (bound {tol}); uint8 route bitwise equal")

    # A 300-fold squeeze along x at 8400 columns: a tile's source rows are
    # wider than the kernel's staging area, so it reads them from device
    # memory instead (f32 and uint8).
    h, w = 8, 8400
    cx = (w - 1) / 2
    maps = torch.tensor([[[a, 0.0, cx - a * cx], [0.0, 1.0, 0.0],
                          [0.0, 0.0, 1.0]] for a in (300.0, -300.0)])
    images = torch.randint(1, 256, (2, h, w, 4), generator=gen).float()
    _, _, err = _check_warp(warp_affine, warp_affine_plain, images.to(DEVICE),
                            maps.to(DEVICE), max_shear, 0, tol, "wide rows")
    worst = max(worst, err)
    print(f"warp 2x{h}x{w}x4, x squeezed 300-fold (rows too wide to stage): "
          f"max |kernel - plain| {err:.3e} (bound {tol}); uint8 route "
          f"bitwise equal")

    h, w = HW
    dgen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    params = sample_augment_params(dgen, TRAIN_BATCH, cfg, HW, DEVICE)
    m_invs = torch.linalg.inv(params.ms.double().cpu()).float().contiguous()
    m_invs = m_invs.to(DEVICE)
    images_u8 = torch.randint(0, 256, (TRAIN_BATCH, h, w, 3), generator=gen,
                              dtype=torch.uint8).to(DEVICE)
    images = images_u8.float()
    _, _, err = _check_warp(warp_affine, warp_affine_plain, images, m_invs,
                            max_shear, 0, tol, "sampled batch")
    worst = max(worst, err)
    print(f"warp sampled batch {TRAIN_BATCH}x{h}x{w}: max |kernel - plain| "
          f"{err:.3e} (bound {tol}); uint8 route bitwise equal to f32")

    call_ms = time_ms(lambda: warp_affine(images, m_invs, max_shear), 50)
    f32_ms = graph_ms(lambda: warp_affine(images, m_invs, max_shear), 20)
    ms = graph_ms(lambda: warp_affine(images_u8, m_invs, max_shear), 20)
    f32_again = graph_ms(lambda: warp_affine(images, m_invs, max_shear), 20)
    plain_ms = time_ms(
        lambda: warp_affine_plain(images_u8.float(), m_invs, max_shear), 5)
    # Context only, a DIFFERENT function: the one-shot bilinear warp.
    theta = torch.stack([
        m_invs[:, 0, :2].flatten(1), m_invs[:, 1, :2].flatten(1)], 1)
    theta = torch.cat([theta, torch.zeros(TRAIN_BATCH, 2, 1, device=DEVICE)], 2)
    nchw = images.permute(0, 3, 1, 2).contiguous()
    oneshot_ms = time_ms(lambda: F.grid_sample(
        nchw, F.affine_grid(theta, nchw.shape, align_corners=False),
        mode="bilinear", padding_mode="zeros", align_corners=False), 20)
    pixels = TRAIN_BATCH * h * w
    flops = pixels * (36 * 3 + 40)
    f32_bms, _ = bound_ms(2 * pixels * 3 * 4 + m_invs.numel() * 4, flops,
                          F32_FLOPS)
    nbytes = pixels * 3 * (1 + 4) + m_invs.numel() * 4
    bms, by = bound_ms(nbytes, flops, F32_FLOPS)
    print(f"warp B={TRAIN_BATCH} {h}x{w}x3, max_shear {max_shear:.3f}, in a "
          f"CUDA graph: f32 in {f32_ms:.4f} / {f32_again:.4f} ms (bound "
          f"{f32_bms:.4f}, {100 * f32_bms / f32_ms:.1f}% of it), uint8 in "
          f"(the training path's route) {ms:.4f} ms (bound {bms:.4f}, "
          f"{100 * bms / ms:.1f}% of it; {nbytes / 1e6:.1f} MB, "
          f"{flops / 1e9:.2f} GFLOP, by {by}); f32 per call from Python "
          f"{call_ms:.4f} ms; plain (uint8 cast, then the two passes) "
          f"{plain_ms:.3f} ms; for context, a different function (one-shot "
          f"bilinear, F.affine_grid + F.grid_sample, f32): {oneshot_ms:.4f} ms")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "max_abs_err": worst, "library_ms": None}


class _RectanglesOnNoise:
    """In-memory dataset in the layout of ``VOCDataset`` items: solid
    class-colored rectangles on noise, the recipe of
    ``odc_tpu_torch.data.voc.make_synthetic_voc`` without the JPEG step,
    already at the network size."""

    def __init__(self, count: int, hw, seed: int):
        from odc_tpu_torch.data.voc import CLASS_LIST

        rng = np.random.default_rng(seed)
        h, w = hw
        levels = [110, 160, 210]
        grid = np.stack(np.meshgrid(levels, levels, levels), -1).reshape(-1, 3)
        palette = grid[
            np.linspace(0, len(grid) - 1, len(CLASS_LIST)).astype(int)]
        self.items = []
        for _ in range(count):
            img = rng.integers(0, 80, (h, w, 3), dtype=np.uint8)
            boxes, labels = [], []
            for _ in range(int(rng.integers(1, 4))):
                bw = int(rng.integers(40, w // 2))
                bh = int(rng.integers(40, h // 2))
                x1 = int(rng.integers(0, w - bw))
                y1 = int(rng.integers(0, h - bh))
                cls_idx = int(rng.integers(0, len(CLASS_LIST)))
                img[y1:y1 + bh, x1:x1 + bw] = np.clip(
                    palette[cls_idx] + rng.integers(-20, 21, 3), 0, 255)
                boxes.append([x1, y1, x1 + bw, y1 + bh])
                labels.append(CLASS_LIST[cls_idx])
            self.items.append((img, {"bbox_list": boxes, "lbl_list": labels}))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index):
        img, annot = self.items[index]
        return index, img, annot


@contextlib.contextmanager
def _count_plain_warps(calls: list):
    """Count calls of the plain two-pass warp, through both names the
    training path could reach it by."""
    from odc_tpu_torch.ops import warp
    from odc_tpu_torch.ops.cuda import warp_kernel

    real = warp.warp_affine_twopass

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    warp.warp_affine_twopass = warp_kernel.warp_affine_twopass = counted
    try:
        yield
    finally:
        warp.warp_affine_twopass = warp_kernel.warp_affine_twopass = real


def _state_tensors(state):
    sd = state.state_dict()
    out = {f"model.{k}": v for k, v in sd["model"].items()}
    out.update({f"momentum.{k}": v for k, v in sd["momentum"].items()})
    return out


def phase_train(counters, model_name: str = "YOLOv2", hw=HW):
    """A training path: model ``model_name`` at ``hw`` (YOLOv2-416,
    YOLOv1-224, whose dropout draws from the trainer's generator, or
    YOLOv3-416, whose loss assigns its own targets), bf16, at batch 32
    through Trainer.fit with in-step device augmentation and the model's
    loss weights; ``counters`` are the wrappers whose launch counts are
    zeroed just before ``fit`` and read just after."""
    import dataclasses

    from odc_tpu_torch.config import TRAIN_CONFIG
    from odc_tpu_torch.data.pipeline import DetectionPipeline
    from odc_tpu_torch.data.prefetch import device_prefetch
    from odc_tpu_torch.models import get_model
    from odc_tpu_torch.models.registry import model_class
    from odc_tpu_torch.ops.augment import (
        AugmentConfig, _invert_affine, apply_augment, sample_augment_params,
        warp_max_shear,
    )
    from odc_tpu_torch.ops.cuda.warp_kernel import (
        warp_affine, warp_affine_plain,
    )
    from odc_tpu_torch.train import checkpoint
    from odc_tpu_torch.train.trainer import (
        Trainer, TrainState, make_train_step,
    )

    t0 = time.perf_counter()
    train_set = _RectanglesOnNoise(TRAIN_IMAGES, hw, SEED + 7)
    val_set = _RectanglesOnNoise(VAL_IMAGES, hw, SEED + 8)
    mode = model_class(model_name).mode
    label = f"{model_name}-{hw[0]} bf16"
    # The model's loss weights (v3: xy and wh at 1), the static size: no
    # multi-scale re-targeting.
    config = dataclasses.replace(
        TRAIN_CONFIG[model_name]["VOC2012"],
        learning_rate_list=[1e-3], num_epoch_list=[TRAIN_EPOCHS],
        batch_size=TRAIN_BATCH, momentum=0.9, multiscale_sizes=(), seed=SEED,
    )
    train_pipe = DetectionPipeline(
        train_set, hw, TRAIN_BATCH, config.max_boxes, mode=mode, seed=SEED)
    val_pipe = DetectionPipeline(
        val_set, hw, TRAIN_BATCH, config.max_boxes, mode=mode, shuffle=False,
        drop_remainder=False)

    shape = _v1_kwargs(hw) if mode == "v1" else dict(image_size=hw)

    def make_model(seed):
        return get_model(model_name, dtype=torch.bfloat16, device=DEVICE,
                         seed=seed, **shape)

    model = make_model(SEED)
    steps = TRAIN_EPOCHS * len(train_pipe)
    print(f"datasets and model built in {time.perf_counter() - t0:.1f} s; "
          f"{steps} steps of batch {TRAIN_BATCH}")

    with tempfile.TemporaryDirectory() as ckpt_path:
        trainer = Trainer(model, train_pipe, val_pipe, config, ckpt_path,
                          augment_cfg=AugmentConfig())
        state = trainer.init_state()
        before = {k: v.clone() for k, v in _state_tensors(state).items()}
        plain_calls: list = []
        torch.cuda.reset_peak_memory_stats()
        for wrapper in counters.values():
            wrapper.launches = 0
        t = time.perf_counter()
        with _count_plain_warps(plain_calls):
            state, history = trainer.fit(state)
        sync()
        fit_s = time.perf_counter() - t
        launches = {name: w.launches for name, w in counters.items()}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        print(f"main path (training): fit took {fit_s:.2f} s for {steps} "
              f"train steps and {TRAIN_EPOCHS} val epochs, launches "
              f"{launches}, plain warps {len(plain_calls)}, peak device "
              f"memory {peak_gb:.2f} GB")
        if launches["warp_affine"] != steps or plain_calls:
            raise AssertionError(
                "the warp kernel must launch once per train step and the "
                "plain warp never")
        if any(n for k, n in launches.items() if k != "warp_affine"):
            raise AssertionError(f"{label}: training launched {launches}")
        losses = history["train_loss_mean_list"] + history["val_loss_list"]
        print(f"train loss per epoch {history['train_loss_mean_list']}, val "
              f"{history['val_loss_list']}")
        if len(losses) != 2 * TRAIN_EPOCHS or not all(
                math.isfinite(x) for x in losses):
            raise AssertionError(f"non-finite or missing losses: {history}")
        if state.step != steps:
            raise AssertionError(f"step {state.step} != {steps}")

        after = _state_tensors(state)
        moved = {kind: 0 for kind in ("param", "momentum", "bn stat")}
        for name, old in before.items():
            if name.endswith("num_batches_tracked"):
                continue
            kind = ("momentum" if name.startswith("momentum.") else
                    "bn stat" if ".running_" in name else "param")
            if not bool(torch.isfinite(after[name]).all()):
                raise AssertionError(f"{name} is not finite after training")
            if torch.equal(old, after[name]):
                raise AssertionError(f"{name} did not change in training")
            moved[kind] += 1
        print(f"state moved and finite: {moved}")

        for fname in ("train_config.json", "metrics.jsonl",
                      "training_result.pkl", "best_model.ckpt",
                      "final_model.ckpt"):
            if not os.path.exists(os.path.join(ckpt_path, fname)):
                raise AssertionError(f"artifact {fname} missing")
        other = TrainState(make_model(SEED + 1))
        checkpoint.restore(os.path.join(ckpt_path, "final_model.ckpt"), other)
        restored = _state_tensors(other)
        if other.step != state.step or not all(
                torch.equal(after[k], restored[k]) for k in after):
            raise AssertionError("restore did not reproduce the train state")
        with open(os.path.join(ckpt_path, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        fit_rates = [r["images_per_sec"] for r in rows
                     if r["kind"] == "train_epoch"]
        print(f"artifacts written, restore reproduces the state; "
              f"Trainer's own img/s per epoch (pipeline and copies "
              f"included, first epoch with warm-up): "
              f"{[round(x, 1) for x in fit_rates]}")

    batches = device_prefetch(train_pipe, DEVICE)
    batch = next(batches)
    batches.close()  # stops the pipeline's prefetch thread
    if batch.image.dtype != torch.uint8:
        raise AssertionError("the train batch must reach the warp as uint8")
    # One step's augmented batch: kernel vs plain two-pass warp.
    cfg = AugmentConfig()
    params = sample_augment_params(
        trainer.generator, TRAIN_BATCH, cfg, hw, DEVICE)
    img_k, box_k, val_k = apply_augment(
        batch.image, batch.box, batch.valid, params, cfg, "kernel")
    img_p, box_p, val_p = apply_augment(
        batch.image, batch.box, batch.valid, params, cfg, "twopass")
    diff = (img_k.int() - img_p.int()).abs()
    share = float((diff != 0).float().mean())
    print(f"augmented uint8 batch, kernel vs plain warp: max level "
          f"difference {int(diff.max())}, differing pixels {share:.2e} of "
          f"{diff.numel()}; boxes and validity equal: "
          f"{torch.equal(box_k, box_p) and torch.equal(val_k, val_p)}")
    if int(diff.max()) > 1 or not torch.equal(box_k, box_p):
        raise AssertionError("augmented batch differs by more than 1 level")
    # The warp alone on the step's own images and maps, both routes.
    _, _, err = _check_warp(
        warp_affine, warp_affine_plain, batch.image.float(),
        _invert_affine(params.ms), warp_max_shear(cfg), 0, 1e-3,
        f"{label} step batch")
    print(f"warp kernel vs plain on the step's images "
          f"{tuple(batch.image.shape)} and maps: max |kernel - plain| "
          f"{err:.3e} (bound 1e-3); uint8 route bitwise equal to f32")

    # Steady-state step time on a resident batch, host clock, synchronised.
    step_ms = []
    for i in range(3 + TIMED_STEPS):
        t = time.perf_counter()
        trainer.train_step(state, batch, 1e-3, trainer.generator)
        sync()
        if i >= 3:
            step_ms.append((time.perf_counter() - t) * 1e3)
    med = statistics.median(step_ms)
    q = statistics.quantiles(step_ms, n=4)
    img_s = TRAIN_BATCH / med * 1e3
    print(f"{label} train step, batch {TRAIN_BATCH}, batch on the "
          f"card: median {med:.3f} ms/step (quartiles {q[0]:.3f} / "
          f"{q[2]:.3f}, n={len(step_ms)}) -> {img_s:.1f} img/s")

    # Device time per part of the step, CUDA events at the step's marks.
    marks = []

    def on_phase(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    marked_step = make_train_step(
        trainer.mode, trainer.lambdas, trainer.anchors,
        momentum=config.momentum, weight_decay=config.weight_decay,
        augment_cfg=cfg, on_phase=on_phase)
    totals, iters = {}, 5
    for it in range(iters + 1):
        marks.clear()
        on_phase("start")
        marked_step(state, batch, 1e-3, trainer.generator)
        sync()
        if it == 0:
            continue
        for (_, a), (name, b) in zip(marks, marks[1:]):
            totals[name] = totals.get(name, 0.0) + a.elapsed_time(b) / iters
    total = sum(totals.values())
    print(f"{label} train step breakdown, device ms per step (CUDA events, "
          f"{iters} steps): " + ", ".join(
              f"{k} {v:.3f} ({100 * v / total:.1f}%)" for k, v in totals.items())
          + f"; sum {total:.3f}")
    _profile(lambda: trainer.train_step(state, batch, 1e-3, trainer.generator),
             also=("warp_affine",))
    return launches, img_s


# Native-size eval: two VOC-shaped buckets of 16 (landscape, portrait), each
# with a bucket-filling image and odd extents; the first six sizes of each
# are fixed, the rest drawn in the bucket's range from the seed.
NATIVE_BATCH = 16
NATIVE_BUCKETS = {
    (384, 512): [(384, 512), (375, 500), (366, 500), (353, 481), (375, 499),
                 (383, 511)],
    (512, 384): [(512, 384), (500, 375), (500, 366), (481, 353), (499, 375),
                 (511, 383)],
}
NATIVE_TIMED = 10
# Eval: 64 synthetic VOC val images at three VOC sizes.
EVAL_SIZES = ((375, 500, 22), (500, 375, 21), (333, 500, 21))
# int8 accuracy on a trained model: overfit 8 images at 96x96.
MAP_HW, MAP_STEPS = (96, 96), 80


def _native_bucket(bucket, sizes, gen):
    """A padded bucket batch of random images: (uint8 [B, H, W, 3] on the
    card, valid_hw int32 numpy, the native images on the card)."""
    bh, bw = bucket
    rng = np.random.default_rng(int(torch.randint(0, 2**31, (1,),
                                                  generator=gen)))
    sizes = list(sizes)
    while len(sizes) < NATIVE_BATCH:
        sizes.append((int(rng.integers(bh - 31, bh + 1)),
                      int(rng.integers(bw - 31, bw + 1))))
    imgs = torch.zeros((NATIVE_BATCH, bh, bw, 3), dtype=torch.uint8)
    natives = []
    for j, (h, w) in enumerate(sizes):
        img = torch.randint(0, 256, (h, w, 3), generator=gen,
                            dtype=torch.uint8)
        imgs[j, :h, :w] = img
        natives.append(img.to(DEVICE))
    return imgs.to(DEVICE), np.array(sizes, np.int32), natives


def _valid_conf(conf, vhw):
    """The confidences of the cells inside each image's native grid."""
    return torch.cat([conf[j, : h // 32, : w // 32].flatten()
                      for j, (h, w) in enumerate(vhw)])


@contextlib.contextmanager
def _recording_suppress(calls: list):
    """Record the (candidates, survivors, threshold) the batched NMS hands
    the suppression kernel's wrapper."""
    from odc_tpu_torch.core import nms

    real = nms.suppress

    def record(cand, surv, thr):
        calls.append((cand, surv, thr))
        return real(cand, surv, thr)

    nms.suppress = record
    try:
        yield
    finally:
        nms.suppress = real


def phase_native(model, scales, counters):
    """Native-size inference over padded buckets (the evaluation path of
    ``evaluate_batched_native``): two VOC-shaped buckets of 16 through
    ``make_native_infer_fn``, bf16 and int8 (s2d stem); ``counters`` are
    zeroed just before the calls and read just after.  Then the checks:
    masked heads against native-size runs, bitwise int8 neck codes with the
    plain stem, NMS and GEMMs against their plain versions on this path's
    inputs, the superstem at a native odd size."""
    from odc_tpu_torch.models.yolov2 import YOLOv2
    from odc_tpu_torch.ops import int8_engine as te
    from odc_tpu_torch.ops.cuda.matmul_kernel import (
        matmul, matmul_plain, route,
    )
    from odc_tpu_torch.ops.cuda.nms_kernel import suppress, suppress_plain
    from odc_tpu_torch.ops.cuda.superstem_kernel import (
        superstem, superstem_plain,
    )
    from odc_tpu_torch.ops.detect import make_native_infer_fn, stem_weights

    gen = torch.Generator().manual_seed(SEED + 11)
    buckets = {b: _native_bucket(b, sizes, gen)
               for b, sizes in NATIVE_BUCKETS.items()}

    @torch.no_grad()
    def gap_threshold(prec, imgs, vhw):
        """A runtime threshold in the largest gap of the bucket's candidates
        (8 to 48 survivors an image), from a masked forward that launches
        no counted kernel (the int8 one through the plain GEMM)."""
        if prec == "bf16":
            y = model(imgs, valid_hw=vhw)
        else:
            with _swap_matmul(lambda real, a, b: matmul_plain(a, b)):
                y = te.yolov2_int8_forward(model, imgs, scales=scales,
                                           stem="s2d", valid_hw=vhw)
        conf = _valid_conf(torch.sigmoid(y[..., 4]), vhw)
        return _gap_threshold(conf, 8 * NATIVE_BATCH, 48 * NATIVE_BATCH)

    infers = {
        "bf16": make_native_infer_fn(model, 0.9, 0.5, MAX_KEEP),
        "int8": make_native_infer_fn(model, 0.9, 0.5, MAX_KEEP,
                                     int8_scales=scales, int8_stem="s2d"),
    }
    want = {"bf16": {"int8_matmul": 0, "nms_suppress": 1, "superstem": 0},
            "int8": {"int8_matmul": 20, "nms_suppress": 1, "superstem": 0}}
    mm = counters["int8_matmul"]
    for wrapper in counters.values():
        wrapper.launches = 0
    mm.launches_by_route = dict.fromkeys(mm.launches_by_route, 0)
    # Each bucket's first call (the first of its shapes on this path, at
    # the product threshold 0.9), then NATIVE_TIMED calls at the gap
    # threshold.
    times, outs, thre, n_calls = {}, {}, {}, 0
    for prec, infer in infers.items():
        for b, (imgs, vhw, _) in buckets.items():
            call_ms = []
            for i in range(1 + NATIVE_TIMED):
                if i == 1:
                    thre[b, prec] = gap_threshold(prec, imgs, vhw)
                before = {k: w.launches for k, w in counters.items()}
                routes_before = dict(mm.launches_by_route)
                t = time.perf_counter()
                out = infer(imgs, vhw, conf_thre=thre[b, prec] if i else 0.9)
                sync()
                call_ms.append((time.perf_counter() - t) * 1e3)
                n_calls += 1
                step = {k: w.launches - before[k] for k, w in counters.items()}
                routes = {k: v - routes_before[k]
                          for k, v in mm.launches_by_route.items()}
                if step != want[prec] or routes["mma_sync"]:
                    raise AssertionError(f"native {prec} {b} call {i}: "
                                         f"launches {step}, routes {routes}")
            times[prec, b] = call_ms
            outs[prec, b] = out
    launches = {k: w.launches for k, w in counters.items()}
    print(f"native path: {n_calls} calls of buckets {list(buckets)} x "
          f"{NATIVE_BATCH}, bf16 and int8; launches {launches}, GEMM launches "
          f"by route {dict(mm.launches_by_route)}; 1 NMS launch a call, 20 "
          f"GEMMs (all wgmma) an int8 call, no superstem")

    summary = {}
    for (prec, b), call_ms in times.items():
        med = statistics.median(call_ms[1:])
        img_s = NATIVE_BATCH / med * 1e3
        summary[f"{prec} {b[0]}x{b[1]}"] = (round(med, 3), round(img_s, 1))
        boxes, conf, lbl, score, keep = outs[prec, b]
        vhw = buckets[b][1]
        if not all(bool(torch.isfinite(t).all()) for t in (boxes, conf, score)):
            raise AssertionError(f"native {prec} {b}: non-finite outputs")
        if (keep.shape != (NATIVE_BATCH, MAX_KEEP) or lbl.dtype != torch.int32
                or bool((conf[keep] < thre[b, prec]).any())):
            raise AssertionError(f"native {prec} {b}: bad outputs")
        # Kept boxes lie in each image's own frame (loosely: centers inside).
        cx = (boxes[..., 0] + boxes[..., 2]) / 2
        cy = (boxes[..., 1] + boxes[..., 3]) / 2
        hw = torch.tensor(vhw, device=DEVICE, dtype=torch.float32)
        inside = ((cx <= hw[:, 1:2] + 1e-3) & (cy <= hw[:, 0:1] + 1e-3)
                  & (cx >= 0) & (cy >= 0))
        if not bool(inside[keep].all()) or not bool(keep.any()):
            raise AssertionError(f"native {prec} {b}: box centers off-image")
        print(f"native {prec} bucket {b[0]}x{b[1]}, batch {NATIVE_BATCH}: first "
              f"call (conf 0.9) {call_ms[0]:.3f} ms, then at conf "
              f"{thre[b, prec]:.6f} median {med:.3f} ms/call (min {min(call_ms[1:]):.3f}, max "
              f"{max(call_ms[1:]):.3f}, n={len(call_ms) - 1}) -> {img_s:.1f} "
              f"img/s; kept per image {keep.sum(1).tolist()}")
    first = next(iter(buckets))
    imgs, vhw, natives = buckets[first]
    for prec, infer in infers.items():
        print(f"native {prec}, bucket {first[0]}x{first[1]}:", end=" ")
        _profile(lambda: infer(imgs, vhw, conf_thre=thre[first, prec]))

    # Masked heads against native-size runs, 3 images a bucket: f32 within
    # 1e-3 of the head's range (the f32 forward tolerance of the CPU tests:
    # another shape, another summation order); bf16 within 2x the model's
    # bf16 noise (the bf16 native run against the f32 one), as in
    # phase_e2e; the int8 s2d head within 5% of its range (the JAX
    # package's budget: the lifted stem is a bf16 conv whose codes may flip
    # by one level across shapes); the plain-stem int8 neck codes bitwise.
    failures = []
    model32 = YOLOv2(dtype=torch.float32, device=DEVICE, seed=SEED)
    model32.load_state_dict(model.state_dict())
    model32.eval()
    for b, (b_imgs, b_vhw, b_natives) in buckets.items():
        with torch.no_grad():
            y16 = model(b_imgs, valid_hw=b_vhw)
            y32 = model32(b_imgs, valid_hw=b_vhw)
            plain = te.yolov2_int8_forward(model, b_imgs, scales=scales,
                                           stem="plain", valid_hw=b_vhw,
                                           stop_after=21)
            y8 = te.yolov2_int8_forward(model, b_imgs, scales=scales,
                                        stem="s2d", valid_hw=b_vhw)
        for j in (0, 1, 2):
            h, w = (int(v) for v in b_vhw[j])
            gh, gw = h // 32, w // 32
            x = b_natives[j][None]
            with torch.no_grad():
                n16, n32 = model(x), model32(x)
                n_plain = te.yolov2_int8_forward(model, x, scales=scales,
                                                 stem="plain", stop_after=21)
                n8 = te.yolov2_int8_forward(model, x, scales=scales,
                                            stem="s2d")
            err32 = float((y32[j, :gh, :gw] - n32[0]).abs().max())
            err16 = float((y16[j, :gh, :gw] - n16[0]).abs().max())
            noise = float((n16 - n32).abs().max())
            err8 = float((y8[j, :gh, :gw] - n8[0]).abs().max())
            rng8 = float(n8.abs().max())
            codes = torch.equal(plain[j, :gh, :gw], n_plain[0])
            rng32 = float(n32.abs().max())
            print(f"native {h}x{w} in bucket {b[0]}x{b[1]}: masked vs native "
                  f"head max |diff| f32 {err32:.2e} (bound {1e-3 * rng32:.2e}),"
                  f" bf16 {err16:.4f} (bound 2n = {2 * noise:.4f}), int8 s2d "
                  f"{err8:.4f} (bound 5% of {rng8:.3f}); int8 plain-stem neck "
                  f"codes bitwise equal: {codes}")
            if not (err32 <= 1e-3 * rng32 and err16 <= 2 * noise
                    and err8 <= 0.05 * rng8 and codes):
                failures.append(f"{h}x{w}")
    del model32, y16, y32, plain, y8
    if failures:
        raise AssertionError(f"native: masked != native for {failures}")

    # NMS on this path's own candidates, and each GEMM of one int8 call,
    # on the first bucket.
    calls = []
    with _recording_suppress(calls):
        for prec, infer in infers.items():
            infer(imgs, vhw, conf_thre=thre[first, prec])
    for cand, surv, thr in calls:
        keep = suppress(cand, surv, thr)
        if not torch.equal(keep, suppress_plain(cand, surv, thr)):
            raise AssertionError("native NMS kernel != plain")
        print(f"native NMS B={cand.shape[0]} K={cand.shape[1]}: "
              f"{int(surv.sum())} survivors, {int(keep.sum())} kept, kernel "
              f"== plain")
    recorded = []

    def record(real, a, b):
        recorded.append((a, b))
        return real(a, b)

    with _swap_matmul(record), torch.no_grad():
        te.yolov2_int8_forward(model, imgs, scales=scales, stem="s2d",
                               valid_hw=vhw)
    for i, (a, b) in enumerate(recorded):
        m, k = a.shape
        if route(m, b.shape[1], k, a.dtype, a, b) != "wgmma":
            raise AssertionError(f"native GEMM {i}: not the wgmma route")
        if not torch.equal(matmul(a, b), matmul_plain(a, b)):
            raise AssertionError(f"native GEMM {i}: kernel != plain")
    print(f"native int8 call: {len(recorded)} GEMMs, M from "
          f"{min(a.shape[0] for a, _ in recorded)} to "
          f"{max(a.shape[0] for a, _ in recorded)}, all wgmma, each bitwise "
          f"equal to the plain GEMM")
    if len(recorded) != 20:
        raise AssertionError("native int8 call: not 20 GEMMs")
    del recorded

    # The superstem at a native odd size (Detector.detect feeds these): the
    # first bucket's second image, 375x500.
    w1, w2 = stem_weights(model)
    x = natives[1][None].expand(4, -1, -1, -1).contiguous()
    with torch.no_grad():
        got, ref = superstem(x, w1, w2), superstem_plain(x, w1, w2)
    err, tol = float((got.float() - ref.float()).abs().max()), _bf16_ulp(ref)
    print(f"superstem at native {x.shape[1]}x{x.shape[2]} (B=4): max |kernel "
          f"- plain| {err} (bound 1 ulp = {tol})")
    if got.shape != ref.shape or not err <= tol:
        raise AssertionError("superstem at a native odd size beyond 1 ulp")
    return summary


def _voc_val(sizes, root):
    """One VOC val dataset of synthetic JPEGs at several sizes:
    ``make_synthetic_voc`` once per size."""
    from odc_tpu_torch.data.voc import VOC, VOCDataset, make_synthetic_voc

    paths, annots = [], []
    for k, (h, w, n) in enumerate(sizes):
        sub = os.path.join(root, f"s{k}")
        make_synthetic_voc(sub, num_train=0, num_val=n, image_hw=(h, w),
                           seed=SEED + k)
        voc = VOC(dataset_dir=sub)
        paths += voc.val_img_path_list
        annots += voc.val_annot_list
    return VOCDataset(paths, annots)


def _map_scores(result, cls_list):
    aps = np.stack([result[c] for c in cls_list])
    if aps.shape != (len(cls_list), 10) or not np.isfinite(aps).all():
        raise AssertionError("mAP vectors malformed")
    return float(aps[:, 0].mean()), float(aps.mean())


# Serving from exported artifacts (phase serve): YOLOv2-416 at the main
# path's batch, a symbolic-batch artifact behind the BatchingServer and the
# HTTP door, and YOLOv1-224 / YOLOv3-416 artifacts at a small batch.
SERVE_CLIENTS, SERVE_REQUESTS = 8, 1024
HTTP_CLIENTS, HTTP_POSTS, HTTP_BODY = 4, 8, 16
SERVE_SMALL_BATCH = 8


def _labels(out):
    """Labels of an engine output tuple, compact or not."""
    return out[2] if len(out) == 5 else out[2].argmax(-1)


def _served_equal(label, got, ref) -> bool:
    """The loaded artifact's outputs against the direct call's.  Bitwise is
    expected; otherwise the keep masks and labels must be equal and boxes
    and confidences within rtol 1e-3 (a difference for ROADMAP Queue 3,
    printed), else the phase fails."""
    if all(torch.equal(g, r) for g, r in zip(got, ref)):
        return True
    if not (torch.equal(got[-1], ref[-1])
            and torch.equal(_labels(got), _labels(ref))):
        raise AssertionError(f"serve {label}: keep masks or labels differ "
                             "from the direct call")
    for name, g, r in (("boxes", got[0], ref[0]), ("conf", got[1], ref[1])):
        scale = float(r.abs().max()) or 1.0
        torch.testing.assert_close(g, r, rtol=1e-3, atol=1e-3 * scale,
                                   msg=f"serve {label}: {name}")
    diffs = [float((g.float() - r.float()).abs().max())
             for g, r in zip(got[:-1], ref[:-1])]
    print(f"serve {label}: NOT bitwise the direct call (keep masks and "
          f"labels equal; max |diff| per output {diffs})")
    return False


def _zero(counters):
    mm = counters["int8_matmul"]
    for wrapper in counters.values():
        wrapper.launches = 0
    mm.launches_by_route = dict.fromkeys(mm.launches_by_route, 0)


def _read(counters):
    out = {k: w.launches for k, w in counters.items()}
    out["wgmma"] = counters["int8_matmul"].launches_by_route["wgmma"]
    return out


def _add(total, step):
    for k, v in step.items():
        total[k] = total.get(k, 0) + v


def _dtoh_copies(fn) -> int:
    """Device-to-host copies in one call of ``fn`` (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        sync()
    return sum("DtoH" in e.name for e in prof.events())


def _export_load(label, export, tmp):
    """Export (``export()`` gives the bytes), save into ``tmp``, load from
    the file and delete it: (engine, export s, MB, load s)."""
    from odc_tpu_torch.serve import load_engine, save_engine

    t = time.perf_counter()
    data = export()
    export_s = time.perf_counter() - t
    mb = len(data) / 1e6
    path = os.path.join(tmp, f"{label}.odce")
    save_engine(path, data)
    del data
    t = time.perf_counter()
    engine = load_engine(path, DEVICE)
    sync()
    load_s = time.perf_counter() - t
    os.remove(path)
    return engine, export_s, mb, load_s


def _hop_us():
    """Host µs a launch that the operator adds on this machine: the NMS
    launcher called directly, the operator, and the wrapper (checks, then
    the operator), 2000 calls each on the main path's candidate shape,
    queued back to back (each is host-bound: the kernel takes 5.5 µs), three
    times in turns.  Returns the medians in that order."""
    from odc_tpu_torch.ops.cuda import nms_kernel

    gen = torch.Generator().manual_seed(SEED + 43)
    boxes = torch.rand(BATCH, MAX_KEEP, 4, generator=gen).to(DEVICE)
    boxes[..., 2:] += boxes[..., :2]
    valid = (torch.rand(BATCH, MAX_KEEP, generator=gen) < 0.7).to(DEVICE)
    iou = torch.tensor(0.5)
    fns = [lambda: nms_kernel._launch(boxes, valid, 0.5),
           lambda: torch.ops.odc_tpu_torch.nms_suppress(boxes, valid, iou),
           lambda: nms_kernel.suppress(boxes, valid, 0.5)]
    times = [[], [], []]
    for _ in range(3):
        for i, fn in enumerate(fns):
            for _ in range(50):
                fn()
            sync()
            t = time.perf_counter()
            for _ in range(2000):
                fn()
            sync()
            times[i].append((time.perf_counter() - t) / 2000 * 1e6)
    return [statistics.median(t) for t in times]


def _served_run(label, engine, images, counters, want, calls):
    """``calls`` calls of the loaded program on ``images`` on the card, the
    launch counts set to 0 just before and read just after, each call
    checked for ``want`` launches.  Returns (ms per call, launches); the
    first entry is the first call after loading."""
    _zero(counters)
    call_ms = []
    for i in range(calls):
        before = _read(counters)
        t = time.perf_counter()
        engine.forward(images)
        sync()
        call_ms.append((time.perf_counter() - t) * 1e3)
        step = {k: v - before[k] for k, v in _read(counters).items()}
        if step != want:
            raise AssertionError(f"serve {label} call {i}: launches {step}, "
                                 f"want {want}")
    return call_ms, _read(counters)


def _serve_batch(label, model, images, counters, tmp, want, **kw):
    """YOLOv2-416 at the main path's batch from an artifact: export, size,
    load, first call, median of 20 calls on device tensors against the
    direct ``make_infer_fn`` call, ``predict`` with its numpy round trip,
    equality with the direct call at conf 0.9 and 0.0, and the
    device-to-host copies of one call."""
    from odc_tpu_torch.ops.detect import make_infer_fn
    from odc_tpu_torch.serve import export_engine

    engine, export_s, mb, load_s = _export_load(label, lambda: export_engine(
        model, batch_size=BATCH, image_hw=HW, max_keep=MAX_KEEP, **kw), tmp)
    call_ms, launches = _served_run(label, engine, images, counters, want,
                                    1 + 3 + TIMED_CALLS)
    first_ms, served_ms = call_ms[0], call_ms[4:]
    direct = make_infer_fn(model, 0.9, 0.5, MAX_KEEP, **kw)
    direct_ms = []
    for i in range(3 + TIMED_CALLS):
        t = time.perf_counter()
        direct(images)
        sync()
        if i >= 3:
            direct_ms.append((time.perf_counter() - t) * 1e3)
    host = images.cpu().numpy()
    _zero(counters)
    predict_ms = []
    for i in range(2 + TIMED_CALLS // 2):
        t = time.perf_counter()
        outs = engine.predict(host)
        if i >= 2:
            predict_ms.append((time.perf_counter() - t) * 1e3)
    _add(launches, _read(counters))
    if outs[0].shape != (BATCH, MAX_KEEP, 4):
        raise AssertionError(f"serve {label}: predict shapes")
    bitwise = True
    for conf in (0.9, 0.0):
        got = engine.forward(images, conf)
        ref = direct(images, conf_thre=conf)
        bitwise &= _served_equal(f"{label} conf {conf}", got, ref)
        if not all(bool(torch.isfinite(t).all()) for t in got[:-1]):
            raise AssertionError(f"serve {label}: non-finite outputs")
        print(f"serve {label} at conf {conf}: kept per image "
              f"{got[-1].sum(1).tolist()[:16]} ... (artifact "
              f"{'==' if bitwise else '~'} direct call)")
    d2h = (_dtoh_copies(lambda: engine.forward(images)),
           _dtoh_copies(lambda: direct(images)))
    if d2h[0] > d2h[1]:
        raise AssertionError(f"serve {label}: the artifact copies to the "
                             f"host {d2h[0]} times a call, the direct call "
                             f"{d2h[1]}")
    med = statistics.median(served_ms)
    q = statistics.quantiles(served_ms, n=4)
    res = dict(export_s=export_s, mb=mb, load_s=load_s, first_ms=first_ms,
               ms=med, direct_ms=statistics.median(direct_ms),
               predict_ms=statistics.median(predict_ms), bitwise=bitwise)
    print(f"serve {label}, batch {BATCH}: export {export_s:.2f} s, artifact "
          f"{mb:.1f} MB, load {load_s:.2f} s, first call {first_ms:.3f} ms; "
          f"loaded program median {med:.3f} ms/call (quartiles {q[0]:.3f} / "
          f"{q[2]:.3f}, n={len(served_ms)}) -> {BATCH / med * 1e3:.1f} img/s; "
          f"direct make_infer_fn {res['direct_ms']:.3f} ms; predict (numpy "
          f"in and out) {res['predict_ms']:.3f} ms; device-to-host copies a "
          f"call: artifact {d2h[0]}, direct {d2h[1]}; launches {launches}")
    return engine, launches, res


def _serve_clients(engine, images, counters):
    """The BatchingServer over a symbolic-batch engine (max_batch 64,
    5 ms delay): SERVE_CLIENTS threads, each submitting its share of
    SERVE_REQUESTS single images one after another.  Returns (img/s, p50
    ms, p99 ms, mean device batch, launches)."""
    import threading

    from odc_tpu_torch.serve import BatchingServer

    per = SERVE_REQUESTS // SERVE_CLIENTS
    lat, errors = [[] for _ in range(SERVE_CLIENTS)], []

    def client(c, srv):
        try:
            for j in range(per):
                t = time.perf_counter()
                out = srv.submit(images[(c * per + j) % len(images)]).result(
                    timeout=300)
                lat[c].append((time.perf_counter() - t) * 1e3)
                if out[0].shape != (MAX_KEEP, 4):
                    raise AssertionError("server: output shape")
        except Exception as e:  # surfaced below
            errors.append(e)

    _zero(counters)
    with BatchingServer(engine, max_batch=BATCH, max_delay_ms=5) as srv:
        threads = [threading.Thread(target=client, args=(c, srv))
                   for c in range(SERVE_CLIENTS)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t
    launches = _read(counters)
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"server clients failed: {errors[:1]}")
    stats = srv.stats
    if stats["images"] != SERVE_REQUESTS:
        raise AssertionError(f"server served {stats['images']} images")
    if (launches["superstem"], launches["nms_suppress"]) != (
            stats["batches"], stats["batches"]):
        raise AssertionError(f"server: launches {launches} for "
                             f"{stats['batches']} device batches")
    every = sorted(x for c in lat for x in c)
    p50, p99 = every[len(every) // 2], every[int(0.99 * len(every))]
    mean_batch = stats["images"] / stats["batches"]
    img_s = SERVE_REQUESTS / wall
    print(f"BatchingServer (symbolic-batch bf16 artifact, max_batch {BATCH}, "
          f"5 ms delay): {SERVE_CLIENTS} clients, {SERVE_REQUESTS} single "
          f"images in {wall:.3f} s -> {img_s:.1f} img/s; latency p50 "
          f"{p50:.3f} ms, p99 {p99:.3f} ms; {stats['batches']} device "
          f"batches, mean {mean_batch:.2f} images; launches {launches}")
    # One full batch, coalesced from single requests, is bit for bit the
    # engine's own call at that batch.
    with BatchingServer(engine, max_batch=BATCH, max_delay_ms=2000) as srv:
        futs = [srv.submit(img) for img in images[:BATCH]]
        got = [f.result(timeout=300) for f in futs]
    if srv.stats["batch_sizes"] != [BATCH]:
        raise AssertionError(f"server: batches {srv.stats['batch_sizes']}")
    ref = engine.predict(images[:BATCH])
    for i, outs in enumerate(got):
        if not all(np.array_equal(g, r[i]) for g, r in zip(outs, ref)):
            raise AssertionError(f"server: image {i} != the engine's call")
    print(f"BatchingServer: {BATCH} single requests coalesced into one device "
          f"batch, every output bitwise the engine's own batch-{BATCH} call")
    return img_s, p50, p99, mean_batch, launches


def _serve_http(engine, images, counters):
    """The HTTP door over a fixed-batch engine: HTTP_CLIENTS concurrent
    clients, each POSTing HTTP_POSTS .npy bodies of HTTP_BODY images; the
    annots must equal ``engine.predict_annots`` of each body.  Returns
    (img/s, launches)."""
    import io
    import threading
    import urllib.request

    from odc_tpu_torch.serve.httpd import start_http_server

    bodies = []  # (client, first image, .npy bytes)
    for c in range(HTTP_CLIENTS):
        for p in range(HTTP_POSTS):
            at = ((c * HTTP_POSTS + p) * HTTP_BODY) % (len(images) - HTTP_BODY)
            buf = io.BytesIO()
            np.save(buf, images[at:at + HTTP_BODY])
            bodies.append((c, at, buf.getvalue()))
    answers, errors = [None] * len(bodies), []
    _zero(counters)
    httpd, batcher = start_http_server(engine, port=0, max_batch=BATCH,
                                       max_delay_ms=5)
    try:
        url = f"http://127.0.0.1:{httpd.server_port}/predict"

        def client(c):
            try:
                for i, (cc, _, body) in enumerate(bodies):
                    if cc != c:
                        continue
                    req = urllib.request.Request(url, data=body,
                                                 method="POST")
                    with urllib.request.urlopen(req, timeout=300) as r:
                        answers[i] = json.loads(r.read())
            except Exception as e:  # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(HTTP_CLIENTS)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t
        stats = dict(batcher.stats)
    finally:
        httpd.shutdown()
        batcher.stop()
    launches = _read(counters)
    n = HTTP_CLIENTS * HTTP_POSTS * HTTP_BODY
    if errors or any(a is None for a in answers):
        raise AssertionError(f"HTTP clients failed: {errors[:1]}")
    for (_, at, _), answer in zip(bodies, answers):
        if answer != engine.predict_annots(images[at:at + HTTP_BODY]):
            raise AssertionError(f"HTTP annots of body at {at} != "
                                 "engine.predict_annots")
    img_s = n / wall
    print(f"HTTP door (fixed batch-{BATCH} bf16 artifact): {HTTP_CLIENTS} "
          f"clients x {HTTP_POSTS} POSTs of {HTTP_BODY} images = {n} images "
          f"in {wall:.3f} s -> {img_s:.1f} img/s; {stats['batches']} device "
          f"batches, mean {stats['images'] / stats['batches']:.2f} images; "
          f"annots equal engine.predict_annots; launches {launches}")
    return img_s, launches


def _serve_small(label, model, hw, counters, tmp, want):
    """A small-batch artifact of ``model``: loaded program == direct call
    at conf 0.9 and 0.0, launches checked.  Returns the launches."""
    from odc_tpu_torch.ops.detect import make_infer_fn
    from odc_tpu_torch.serve import export_engine

    gen = torch.Generator().manual_seed(SEED + 41)
    images = torch.randint(0, 256, (SERVE_SMALL_BATCH, *hw, 3), generator=gen,
                           dtype=torch.uint8).to(DEVICE)
    _calibrate_bn(model, images, torch.Generator().manual_seed(SEED + 42))
    engine, export_s, mb, load_s = _export_load(label, lambda: export_engine(
        model, batch_size=SERVE_SMALL_BATCH, image_hw=hw, max_keep=MAX_KEEP),
        tmp)
    direct = make_infer_fn(model, 0.9, 0.5, MAX_KEEP)
    _zero(counters)
    got = {conf: engine.forward(images, conf) for conf in (0.9, 0.0)}
    sync()
    launches = _read(counters)
    if launches != {k: 2 * v for k, v in want.items()}:
        raise AssertionError(f"serve {label}: launches {launches}, want "
                             f"twice {want}")
    bitwise = all([_served_equal(f"{label} conf {conf}", out,
                                 direct(images, conf_thre=conf))
                   for conf, out in got.items()])
    print(f"serve {label}, batch {SERVE_SMALL_BATCH}: export {export_s:.2f} "
          f"s, artifact {mb:.1f} MB, load {load_s:.2f} s; loaded program "
          f"{'bitwise' if bitwise else 'within rtol 1e-3 of'} the direct "
          f"call at conf 0.9 and 0.0 (kept at 0.0: "
          f"{int(got[0.0][-1].sum())}); launches {launches}")
    return launches


def phase_serve(model, scales, counters):
    """Serving from exported artifacts on the card: the YOLOv2-416 model of
    phase_e2e (and phase_int8_e2e's ranges) exported, saved, loaded and
    served at batch 64 in bf16 and int8_full (s2d); a symbolic-batch bf16
    artifact behind the BatchingServer; the HTTP door; YOLOv1-224 and
    YOLOv3-416 (int8_dynamic) artifacts at batch 8.  Every artifact is
    written into a temporary directory and deleted once loaded.  Returns
    the launches of the served calls by kernel and the numbers."""
    from odc_tpu_torch.models import get_model
    from odc_tpu_torch.serve import export_engine

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 40)
    host = torch.randint(0, 256, (4 * BATCH, *HW, 3), generator=gen,
                         dtype=torch.uint8).numpy()
    images = torch.from_numpy(host[:BATCH]).to(DEVICE)
    zero = dict.fromkeys(["int8_matmul", "nms_suppress", "superstem",
                          "wgmma"], 0)
    served, res = {}, {}
    launcher_us, op_us, wrapper_us = _hop_us()
    res["hop_us"] = op_us - launcher_us
    print(f"custom-op hop, host time a call (NMS at B={BATCH}, K={MAX_KEEP}, "
          f"2000 calls, median of 3): launcher {launcher_us:.2f} us, operator "
          f"{op_us:.2f} us, wrapper {wrapper_us:.2f} us -> the operator adds "
          f"{op_us - launcher_us:.2f} us a launch")
    with tempfile.TemporaryDirectory() as tmp:
        fixed, launches, res["bf16"] = _serve_batch(
            "YOLOv2-416 bf16", model, images, counters, tmp,
            {**zero, "superstem": 1, "nms_suppress": 1})
        _add(served, launches)
        int8, launches, res["int8"] = _serve_batch(
            "YOLOv2-416 int8_full s2d", model, images, counters, tmp,
            {**zero, "int8_matmul": 20, "wgmma": 20, "nms_suppress": 1},
            int8_scales=scales, int8_stem="s2d")
        _add(served, launches)
        del int8
        sym, export_s, mb, load_s = _export_load("sym", lambda: export_engine(
            model, batch_size=None, image_hw=HW, max_keep=MAX_KEEP), tmp)
        print(f"serve YOLOv2-416 bf16 symbolic batch: export {export_s:.2f} "
              f"s, artifact {mb:.1f} MB, load {load_s:.2f} s")
        for b in (1, 2, 4, 8, 16, 32, 64):  # the server's bucket ladder
            sym.forward(images[:b])
        sync()
        img_s, p50, p99, mean_batch, launches = _serve_clients(
            sym, host, counters)
        res["server"] = dict(img_s=img_s, p50_ms=p50, p99_ms=p99,
                             mean_batch=mean_batch)
        _add(served, launches)
        del sym
        res["http"], launches = _serve_http(fixed, host, counters)
        _add(served, launches)
        del fixed
        torch.cuda.empty_cache()
        v1 = get_model("YOLOv1", dtype=torch.bfloat16, device=DEVICE,
                       seed=SEED, **_v1_kwargs(V1_HW)).eval()
        _add(served, _serve_small("YOLOv1-224 bf16", v1, V1_HW, counters, tmp,
                                  {**zero, "nms_suppress": 1}))
        del v1
        torch.cuda.empty_cache()
        v3 = get_model("YOLOv3", dtype=torch.bfloat16, device=DEVICE,
                       seed=SEED, image_size=V3_HW, int8_dynamic=True).eval()
        _add(served, _serve_small(
            "YOLOv3-416 int8_dynamic", v3, V3_HW, counters, tmp,
            {**zero, "int8_matmul": V3_INT8_LAYERS, "wgmma": V3_INT8_LAYERS,
             "nms_suppress": 1}))
        del v3
    torch.cuda.empty_cache()
    print(f"phase serve took {time.perf_counter() - t0:.1f} s; served "
          f"launches {served}")
    return served, res


def phase_eval(model, scales, counters):
    """Both evaluators end to end on 64 synthetic VOC val JPEGs at three
    sizes, host decode included: ``evaluate_batched`` (416x416, batch 64)
    and ``evaluate_batched_native`` (buckets of 16), bf16 and int8."""
    from odc_tpu_torch.core.ap import APAccumulator
    from odc_tpu_torch.eval import (
        Detector, evaluate_batched, evaluate_batched_native,
    )
    from odc_tpu_torch.eval.evaluator import _resize_host

    with tempfile.TemporaryDirectory() as root:
        dataset = _voc_val(EVAL_SIZES, root)
        n = len(dataset)
        # The host's own rate, one thread: JPEG decode, and decode + resize.
        for name, prep in (("decode", lambda img: img),
                           ("decode + resize to 416x416",
                            lambda img: _resize_host(img, HW))):
            t = time.perf_counter()
            for i in range(n):
                prep(dataset[i][1])
            print(f"eval host {name} alone: {n / (time.perf_counter() - t):.1f}"
                  f" img/s")
        detectors = {
            "bf16": Detector(model, conf_thre=0.05),
            "int8": Detector(model, conf_thre=0.05, int8_scales=scales),
        }
        runs = {
            "evaluate_batched 416x416 b64": lambda d: evaluate_batched(
                d, dataset, image_hw=HW, batch_size=BATCH),
            "evaluate_batched_native b16": lambda d: evaluate_batched_native(
                d, dataset, batch_size=NATIVE_BATCH),
        }
        # Host time in the AP accumulation (the main thread's share).
        ap_s = [0.0]
        real_add = APAccumulator.add_image

        def timed_add(self, *args):
            t = time.perf_counter()
            real_add(self, *args)
            ap_s[0] += time.perf_counter() - t

        for prec, det in detectors.items():
            for name, run in runs.items():
                walls = []
                for _ in range(2):  # the first run meets new shapes
                    before = {k: w.launches for k, w in counters.items()}
                    ap_s[0] = 0.0
                    APAccumulator.add_image = timed_add
                    try:
                        t = time.perf_counter()
                        result = run(det)
                        walls.append(time.perf_counter() - t)
                    finally:
                        APAccumulator.add_image = real_add
                step = {k: w.launches - before[k] for k, w in counters.items()}
                m50, m5095 = _map_scores(result, det.cls_list)
                print(f"eval {name} {prec}: {n} images, {n / walls[0]:.1f} "
                      f"img/s on the first run, {n / walls[1]:.1f} img/s on the "
                      f"second (host JPEG decode included; AP accumulation "
                      f"{1e3 * ap_s[0]:.1f} of its {1e3 * walls[1]:.1f} ms); "
                      f"mAP@.5 {m50:.4f}, mAP[.5:.95] {m5095:.4f}; launches of "
                      f"one run {step}")
                if step["nms_suppress"] == 0:
                    raise AssertionError(f"eval {name} {prec}: no NMS launch")
        print("evaluate_batched_native bf16, one run:", end=" ")
        _profile(lambda: evaluate_batched_native(
            detectors["bf16"], dataset, batch_size=NATIVE_BATCH), calls=1)


def _map50(result, cls_list):
    """mAP@.5 over the classes with any AP, as the JAX package's trained-
    model int8 test computes it."""
    lvl = list(np.asarray(result["level_list"])).index(0.5)
    aps = [result[c][lvl] for c in cls_list if np.any(result[c] > 0)]
    return float(np.mean(aps)) if aps else 0.0


def phase_int8_map(model_name: str = "YOLOv2", root=None):
    """int8 accuracy on a TRAINED model (the counterpart of the JAX
    package's test of it): overfit a full-width f32 ``model_name`` (YOLOv2
    or YOLOv3) at 96x96 on 8 synthetic images (80 steps, momentum 0.9, no
    weight decay, lr 1e-3, the model's loss weights, no augmentation, one
    fixed batch), then mAP@.5 through ``evaluate_batched`` (conf 0.1,
    max_keep 16) in f32, bf16 and int8: for YOLOv2 the PTQ engine
    calibrated on the images, for YOLOv3 the bf16 model with
    ``int8_dynamic``.  bf16 must exceed 0.3 and int8 lose at most 0.15 of
    it.  The synthetic VOC goes to ``root`` (a temporary folder if None);
    returns the trained f32 model, its batch, dataset, loss weights, int8
    keyword arguments and scores, for the QAT phase (``root`` must then
    outlive the call: the dataset reads its JPEGs from it)."""
    if root is None:
        with tempfile.TemporaryDirectory() as tmp:
            return phase_int8_map(model_name, tmp)
    from odc_tpu_torch.config import TRAIN_CONFIG
    from odc_tpu_torch.data.pipeline import DetectionPipeline
    from odc_tpu_torch.data.prefetch import device_prefetch
    from odc_tpu_torch.data.voc import VOC, make_synthetic_voc
    from odc_tpu_torch.eval import Detector, evaluate_batched
    from odc_tpu_torch.losses.yolo_loss import Lambdas
    from odc_tpu_torch.models import get_model
    from odc_tpu_torch.ops import int8_engine as te
    from odc_tpu_torch.train.trainer import TrainState, make_train_step

    t0 = time.perf_counter()
    cfg = TRAIN_CONFIG[model_name]["VOC2012"]
    lambdas = Lambdas(cfg.lambda_xy, cfg.lambda_wh, cfg.lambda_conf,
                      cfg.lambda_noobj, cfg.lambda_cls)

    def make(dtype, **kw):
        return get_model(model_name, image_size=MAP_HW, dtype=dtype,
                         device=DEVICE, seed=SEED, **kw)

    make_synthetic_voc(root, num_train=8, num_val=0, image_hw=MAP_HW,
                       seed=SEED)
    voc = VOC(dataset_dir=root)
    model = make(torch.float32)
    state = TrainState(model)
    pipe = DetectionPipeline(voc.train_dataset, MAP_HW, 8, max_boxes=8,
                             mode=model.mode, shuffle=False, prefetch=0)
    batch = next(iter(device_prefetch(pipe, DEVICE)))
    step = make_train_step(model.mode, lambdas, model.anchors,
                           momentum=0.9, weight_decay=0.0)
    losses = []
    for _ in range(MAP_STEPS):
        state, metrics = step(state, batch, 1e-3)
        losses.append(metrics["loss"])
    losses = torch.stack(losses).tolist()
    model16 = make(torch.bfloat16)
    model16.load_state_dict(model.state_dict())
    if model.mode == "v3":
        label, int8_model, kw = "int8_dynamic", make(
            torch.bfloat16, int8_dynamic=True), {}
        int8_model.load_state_dict(model.state_dict())
    else:
        label, int8_model = "int8 (s2d)", model
        kw = dict(int8_scales=te.calibrate(model, batch.image))
    maps = {}
    for name, mdl, kwargs in (("f32", model, {}), ("bf16", model16, {}),
                              ("int8", int8_model, kw)):
        det = Detector(mdl, conf_thre=0.1, iou_thre=0.5, max_keep=16,
                       **kwargs)
        maps[name] = _map50(evaluate_batched(
            det, voc.train_dataset, image_hw=MAP_HW, batch_size=8),
            det.cls_list)
    print(f"int8_map {model_name}: {MAP_STEPS} f32 steps at {MAP_HW[0]}x"
          f"{MAP_HW[1]}, batch 8, loss {losses[0]:.3f} -> {losses[-1]:.4f}; "
          f"mAP@.5 on the 8 trained images (conf 0.1, max_keep 16): f32 "
          f"{maps['f32']:.4f}, bf16 {maps['bf16']:.4f}, {label} "
          f"{maps['int8']:.4f}, drop {maps['bf16'] - maps['int8']:+.4f} "
          f"(bound 0.15); {time.perf_counter() - t0:.1f} s")
    if not math.isfinite(losses[-1]) or not maps["bf16"] > 0.3:
        raise AssertionError(f"int8_map {model_name}: the model did not "
                             f"learn: {maps}")
    if not maps["int8"] >= maps["bf16"] - 0.15:
        raise AssertionError(f"int8_map {model_name}: int8 mAP@.5 dropped "
                             f"beyond 0.15: {maps}")
    return dict(model=model, batch=batch, dataset=voc.train_dataset,
                lambdas=lambdas, int8=kw, maps=maps)


# QAT path: YOLOv2-416 at batch 32, exact mode, in-step device augmentation,
# at the fine-tune learning rate of ``--qat-lr``.  The trained 96x96 model
# gets 20 steps at that rate too: at 1e-3 (the rate the JAX test uses from a
# random init) the first steps overshoot, and one of four overfit models on
# the card ended the steps above its starting loss.
QAT_LR = 1e-4
QAT_MAP_STEPS, QAT_MAP_LR = 20, 1e-4


def _check_launches(what, got, want):
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def _twin_distances(model, model32, images, scales, stem, tf32):
    """The JAX QAT test's distances of the twin (``exact=False``) and the
    engine from the f32 model on ``images``, with cuDNN's TF32 allowed or
    not inside the twin (the twin turns it off itself; ``tf32`` lifts
    that for this measurement)."""
    from odc_tpu_torch.ops import int8_engine as te
    from odc_tpu_torch.ops import qat as tq

    real = tq.ieee_f32_convs
    prev = torch.backends.cudnn.allow_tf32
    if tf32:
        tq.ieee_f32_convs = contextlib.nullcontext
        torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            qat = tq.yolov2_qat_forward(model, images, scales, stem=stem)
    finally:
        tq.ieee_f32_convs = real
        torch.backends.cudnn.allow_tf32 = prev
    with torch.no_grad():
        ref = model32(images)
        eng = te.yolov2_int8_forward(model, images, scales=scales, stem=stem)
    err_eng = (eng - ref).abs()
    return dict(max_qat=float((qat - ref).abs().max()),
                max_eng=float(err_eng.max()),
                mean_d=float((qat - eng).abs().mean()),
                mean_eng=float(err_eng.mean())), eng


def phase_qat(counters, trained):
    """The QAT path (``train/qat.py::finetune_qat``): YOLOv2-416 at batch
    32, f32 parameters from seed 0 with BN calibrated and randomized, the
    activation ranges calibrated on one un-augmented batch of the in-memory
    set (128 train, 32 val images).  Checks the twin against the engine by
    the JAX QAT test's criteria for both stems (distances printed with
    TF32 off and on) and exact mode bitwise equal to the engine; runs
    ``finetune_qat`` exact with device augmentation for two epochs of four
    steps, ``counters`` zeroed just before and read just after (20 GEMMs,
    all wgmma, and 1 warp a step, 20 GEMMs a validation batch, nothing
    else); holds one step's GEMMs against the plain version bitwise and
    its warp against the plain warp within 1e-3; checks frozen BN, the
    shipped scales, the checkpoints and serving from them; times the step
    and its parts and the engine's validation batch; then a short QAT of
    ``trained`` (``phase_int8_map``'s overfit 96x96 YOLOv2) must lower the
    engine's loss on its images and keep its int8 mAP@.5 within 0.15."""
    import dataclasses

    from odc_tpu_torch.config import TRAIN_CONFIG
    from odc_tpu_torch.data.pipeline import DetectionPipeline
    from odc_tpu_torch.data.prefetch import device_prefetch
    from odc_tpu_torch.losses.yolo_loss import Lambdas
    from odc_tpu_torch.models.yolov2 import YOLOv2
    from odc_tpu_torch.ops import qat as tq
    from odc_tpu_torch.ops.augment import (
        AugmentConfig, _invert_affine, sample_augment_params, warp_max_shear,
    )
    from odc_tpu_torch.ops.cuda.matmul_kernel import (
        matmul, matmul_plain, route,
    )
    from odc_tpu_torch.ops.cuda.warp_kernel import (
        warp_affine, warp_affine_plain,
    )
    from odc_tpu_torch.ops.detect import make_infer_fn
    from odc_tpu_torch.train import (
        calibrate_from_pipeline, checkpoint, finetune_qat,
    )
    from odc_tpu_torch.train.qat import make_engine_eval_step
    from odc_tpu_torch.train.trainer import TrainState

    t0 = time.perf_counter()
    gpu = gpu_line()
    cfg = dataclasses.replace(TRAIN_CONFIG["YOLOv2"]["VOC2012"], seed=SEED)
    lambdas = Lambdas(cfg.lambda_xy, cfg.lambda_wh, cfg.lambda_conf,
                      cfg.lambda_noobj, cfg.lambda_cls)
    train_set = _RectanglesOnNoise(TRAIN_IMAGES, HW, SEED + 7)
    val_set = _RectanglesOnNoise(VAL_IMAGES, HW, SEED + 8)
    train_pipe = DetectionPipeline(
        train_set, HW, TRAIN_BATCH, cfg.max_boxes, mode="v2", seed=SEED)
    val_pipe = DetectionPipeline(
        val_set, HW, TRAIN_BATCH, cfg.max_boxes, mode="v2", shuffle=False,
        drop_remainder=False)
    calib_pipe = DetectionPipeline(
        train_set, HW, TRAIN_BATCH, cfg.max_boxes, mode="v2", shuffle=False)
    model = YOLOv2(dtype=torch.bfloat16, device=DEVICE, seed=SEED).eval()
    calib_batches = device_prefetch(calib_pipe, DEVICE)
    images = next(calib_batches).image
    calib_batches.close()  # stops the pipeline's prefetch thread
    _calibrate_bn(model, images, torch.Generator().manual_seed(SEED + 3))
    scales = calibrate_from_pipeline(model, calib_pipe, num_batches=1)
    sync()
    print(f"QAT: model built, BN calibrated, activation ranges calibrated on "
          f"{TRAIN_BATCH} un-augmented images in "
          f"{time.perf_counter() - t0:.1f} s; ranges in "
          f"[{float(scales.min()):.4g}, {float(scales.max()):.4g}]")

    # The twin against the engine and the f32 model at 416x416.
    model32 = YOLOv2(dtype=torch.float32, device=DEVICE, seed=SEED)
    model32.load_state_dict(model.state_dict())
    model32.eval()
    for stem in ("s2d", "plain"):
        for tf32 in (False, True):
            d, eng = _twin_distances(model, model32, images, scales, stem,
                                     tf32)
            ok = (d["max_qat"] <= 1.5 * d["max_eng"] + 1e-4
                  and d["mean_d"] <= 0.75 * d["mean_eng"] + 1e-6)
            print(f"QAT twin, stem {stem}, TF32 {'on ' if tf32 else 'off'}: "
                  f"max |twin - f32| {d['max_qat']:.5f} (bound 1.5 x max "
                  f"|engine - f32| = {1.5 * d['max_eng']:.5f}), mean |twin "
                  f"- engine| {d['mean_d']:.6f} (bound 0.75 x mean |engine "
                  f"- f32| = {0.75 * d['mean_eng']:.6f}): "
                  f"{'within' if ok else 'outside'} the JAX test's criteria")
            if not tf32 and not ok:
                raise AssertionError(f"QAT twin ({stem}) outside the JAX "
                                     f"test's criteria: {d}")
        with torch.no_grad():
            exact = tq.yolov2_qat_forward(model, images, scales, stem=stem,
                                          exact=True)
        if not torch.equal(exact, eng):
            raise AssertionError(f"QAT exact mode ({stem}) != the engine")
    print("QAT exact mode: torch.equal to the engine for both stems")
    # The twin's own switch: with TF32 allowed globally (PyTorch's default
    # for cuDNN) it still computes the IEEE f32 values.
    with torch.no_grad():
        ieee = tq.yolov2_qat_forward(model, images, scales)
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            local = tq.yolov2_qat_forward(model, images, scales)
        finally:
            torch.backends.cudnn.allow_tf32 = prev
    if not torch.equal(local, ieee):
        raise AssertionError("QAT twin: TF32 allowed globally leaks into it")
    print("QAT twin with cuDNN TF32 allowed globally: torch.equal to TF32 "
          "off (ieee_f32_convs)")
    del model32, exact, eng, ieee, local

    # The fine-tune, counted.
    aug = AugmentConfig()
    state = TrainState(model)
    bn_before = {k: v.clone() for k, v in model.state_dict().items()
                 if "running" in k}
    steps = TRAIN_EPOCHS * len(train_pipe)
    val_batches = TRAIN_EPOCHS * len(val_pipe)
    mm = counters["int8_matmul"]
    with tempfile.TemporaryDirectory() as ckpt_path:
        plain_calls: list = []
        for wrapper in counters.values():
            wrapper.launches = 0
        mm.launches_by_route = dict.fromkeys(mm.launches_by_route, 0)
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        with _count_plain_warps(plain_calls):
            state, hist = finetune_qat(
                model, state, train_pipe, val_pipe, scales, ckpt_path,
                epochs=TRAIN_EPOCHS, lr=QAT_LR, momentum=0.9,
                weight_decay=cfg.weight_decay, lambdas=lambdas,
                augment_cfg=aug, seed=SEED)
        sync()
        fit_s = time.perf_counter() - t
        launches = {name: w.launches for name, w in counters.items()}
        by_route = dict(mm.launches_by_route)
        print(f"main path (QAT fine-tune, exact, device augmentation): "
              f"{fit_s:.2f} s for {steps} steps and {val_batches} engine "
              f"validation batches, launches {launches}, GEMM launches by "
              f"route {by_route}, plain warps {len(plain_calls)}, peak "
              f"device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        _check_launches("QAT fine-tune", launches, {
            "int8_matmul": 20 * (steps + val_batches), "nms_suppress": 0,
            "superstem": 0, "warp_affine": steps})
        _check_launches("QAT fine-tune GEMM routes", by_route, {
            "wgmma": 20 * (steps + val_batches), "mma_sync": 0})
        if plain_calls:
            raise AssertionError("QAT: the plain warp ran")
        losses = hist["train_loss_mean_list"] + hist["val_loss_list"]
        print(f"QAT loss per epoch {hist['train_loss_mean_list']}, engine "
              f"val {hist['val_loss_list']}")
        if len(losses) != 2 * TRAIN_EPOCHS or not all(
                math.isfinite(x) for x in losses):
            raise AssertionError(f"QAT: non-finite or missing losses {hist}")
        if state.step != steps:
            raise AssertionError(f"QAT: step {state.step} != {steps}")
        bn_after = model.state_dict()
        for k, v in bn_before.items():
            if not torch.equal(bn_after[k], v):
                raise AssertionError(f"QAT moved the BN statistic {k}")
        if set(os.listdir(ckpt_path)) != {
                "best_qat_model.ckpt", "final_qat_model.ckpt",
                "int8_scales.npy", "metrics.jsonl"}:
            raise AssertionError(f"QAT artifacts {os.listdir(ckpt_path)}")
        shipped = np.load(os.path.join(ckpt_path, "int8_scales.npy"))
        if not np.array_equal(shipped, scales.cpu().numpy()):
            raise AssertionError("int8_scales.npy != the frozen scales")
        after = _state_tensors(state)
        final = checkpoint.restore(
            os.path.join(ckpt_path, "final_qat_model.ckpt"),
            TrainState(YOLOv2(dtype=torch.bfloat16, device=DEVICE,
                              seed=SEED + 1)))
        restored = _state_tensors(final)
        if final.step != state.step or not all(
                torch.equal(after[k], restored[k]) for k in after):
            raise AssertionError("QAT: the final checkpoint does not restore "
                                 "the state")
        best = checkpoint.restore(
            os.path.join(ckpt_path, "best_qat_model.ckpt"),
            TrainState(YOLOv2(dtype=torch.bfloat16, device=DEVICE,
                              seed=SEED + 2)))
        best_step = best.step
        if best_step not in (steps // TRAIN_EPOCHS, steps) or not all(
                bool(torch.isfinite(v).all())
                for v in _state_tensors(best).values()):
            raise AssertionError(f"QAT: best checkpoint at step {best_step}")
        del best, restored, after
        # The tuned state and the shipped scales serve.
        infer = make_infer_fn(final.model, 0.9, 0.5, MAX_KEEP,
                              int8_scales=shipped)
        for conf_thre in (0.9, 0.05):
            before = {k: w.launches for k, w in counters.items()}
            boxes, conf, cls, keep = infer(images, conf_thre=conf_thre)
            sync()
            call = {k: w.launches - before[k] for k, w in counters.items()}
            _check_launches("QAT-tuned int8 serving", call, {
                "int8_matmul": 20, "nms_suppress": 1, "superstem": 0,
                "warp_affine": 0})
            if boxes.shape != (TRAIN_BATCH, MAX_KEEP, 4) or not all(
                    bool(torch.isfinite(t).all()) for t in (boxes, conf)):
                raise AssertionError("QAT-tuned serving: bad outputs")
        print("QAT artifacts written; BN statistics bitwise frozen; "
              "int8_scales.npy == the frozen scales; the final checkpoint "
              f"restores the state, the best one (step {best_step}) "
              "restores; the tuned state serves through make_infer_fn("
              "int8_scales=...) with 20 GEMMs and 1 NMS a call (kept at "
              f"conf 0.05: {int(keep.sum())})")
        del final, infer

    # One step's GEMMs and warp against their plain versions, on the
    # step's own operands and maps.
    step = tq.make_qat_train_step(model, lambdas, scales, momentum=0.9,
                                  weight_decay=cfg.weight_decay,
                                  augment_cfg=aug)
    batches = device_prefetch(train_pipe, DEVICE)
    batch = next(batches)
    batches.close()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    g_state = gen.get_state()
    recorded = []

    def record(real, a, b):
        recorded.append((a, b))
        return real(a, b)

    with _swap_matmul(record):
        step(state, batch, QAT_LR, gen)
    if len(recorded) != 20:
        raise AssertionError(f"QAT step: {len(recorded)} GEMMs")
    for i, (a, b) in enumerate(recorded):
        m, k = a.shape
        if route(m, b.shape[1], k, a.dtype, a, b) != "wgmma":
            raise AssertionError(f"QAT step GEMM {i}: not the wgmma route")
        if not torch.equal(matmul(a, b), matmul_plain(a, b)):
            raise AssertionError(f"QAT step GEMM {i}: kernel != plain")
    rows = [a.shape[0] for a, _ in recorded]
    print(f"QAT step: its 20 GEMMs (M {min(rows)} to {max(rows)}) bitwise "
          f"equal to plain, all on the wgmma route")
    del recorded
    replay = torch.Generator(device=DEVICE)
    replay.set_state(g_state)
    params = sample_augment_params(replay, TRAIN_BATCH, aug, HW, DEVICE)
    _, _, err = _check_warp(
        warp_affine, warp_affine_plain, batch.image.float(),
        _invert_affine(params.ms), warp_max_shear(aug), 0, 1e-3,
        "QAT step batch")
    print(f"QAT step: warp kernel vs plain on the step's images and maps: "
          f"max |kernel - plain| {err:.3e} (bound 1e-3)")

    # Timing: steps on a resident batch, host clock, synchronised.
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for i in range(3 + TIMED_STEPS):
        t = time.perf_counter()
        step(state, batch, QAT_LR, gen)
        sync()
        if i >= 3:
            step_ms.append((time.perf_counter() - t) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    med = statistics.median(step_ms)
    q = statistics.quantiles(step_ms, n=4)
    img_s = TRAIN_BATCH / med * 1e3
    marks = []

    def on_phase(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    marked = tq.make_qat_train_step(model, lambdas, scales, momentum=0.9,
                                    weight_decay=cfg.weight_decay,
                                    augment_cfg=aug, on_phase=on_phase)
    parts, iters = {}, 5
    for it in range(iters + 1):
        marks.clear()
        on_phase("start")
        marked(state, batch, QAT_LR, gen)
        sync()
        if it == 0:
            continue
        for (_, a), (name, b) in zip(marks, marks[1:]):
            parts[name] = parts.get(name, 0.0) + a.elapsed_time(b) / iters
    busy = _profile(lambda: step(state, batch, QAT_LR, gen),
                    also=("matmul_kernel", "warp_affine"))
    eval_step = make_engine_eval_step(model, lambdas, scales)
    eval_ms = []
    for i in range(3 + TIMED_STEPS):
        t = time.perf_counter()
        eval_step(state, batch)
        sync()
        if i >= 3:
            eval_ms.append((time.perf_counter() - t) * 1e3)
    total = sum(parts.values())
    print(f"QAT figures, YOLOv2-416, batch {TRAIN_BATCH}, exact, device "
          f"augmentation ({gpu}): median {med:.3f} ms/step (quartiles "
          f"{q[0]:.3f} / {q[2]:.3f}, n={len(step_ms)}) -> {img_s:.1f} img/s;"
          f" peak device memory {peak_gb:.2f} GB; device busy "
          f"{busy if busy is None else round(busy, 1)}%")
    print(f"QAT step breakdown, device ms per step (CUDA events, {iters} "
          f"steps; {gpu}): " + ", ".join(
              f"{k} {v:.3f} ({100 * v / total:.1f}%)"
              for k, v in parts.items()) + f"; sum {total:.3f}")
    print(f"QAT engine validation batch ({TRAIN_BATCH} images, {gpu}): "
          f"median {statistics.median(eval_ms):.3f} ms (n={len(eval_ms)})")
    del state, step, marked, batch
    qat_s = time.perf_counter() - t0

    # The deliverable, on the overfit 96x96 model.
    _qat_on_trained(trained)
    print(f"QAT phase took {qat_s:.1f} s before the trained-model run")
    return launches, by_route, img_s


def _qat_on_trained(trained):
    """A short exact-mode QAT (``QAT_MAP_STEPS`` steps at ``QAT_MAP_LR``,
    momentum 0.9, no weight decay) of ``phase_int8_map``'s overfit YOLOv2 on
    its own batch, under the scales it was scored with: the engine's loss
    on those images must fall and the int8 mAP@.5 stay within 0.15 of its
    score before."""
    from odc_tpu_torch.eval import Detector, evaluate_batched
    from odc_tpu_torch.ops import qat as tq
    from odc_tpu_torch.train.qat import make_engine_eval_step
    from odc_tpu_torch.train.trainer import TrainState

    model, batch = trained["model"], trained["batch"]
    scales = trained["int8"]["int8_scales"]
    lambdas = trained["lambdas"]
    engine_loss = make_engine_eval_step(model, lambdas, scales)
    state = TrainState(model)
    l0 = float(engine_loss(state, batch))
    step = tq.make_qat_train_step(model, lambdas, scales, momentum=0.9,
                                  weight_decay=0.0)
    losses = []
    for _ in range(QAT_MAP_STEPS):
        state, metrics = step(state, batch, QAT_MAP_LR)
        losses.append(metrics["loss"])
    l1 = float(engine_loss(state, batch))
    det = Detector(model, conf_thre=0.1, iou_thre=0.5, max_keep=16,
                   int8_scales=scales)
    after = _map50(evaluate_batched(det, trained["dataset"], image_hw=MAP_HW,
                                    batch_size=8), det.cls_list)
    before = trained["maps"]["int8"]
    print(f"QAT on the overfit {MAP_HW[0]}x{MAP_HW[1]} YOLOv2: "
          f"{QAT_MAP_STEPS} exact steps at lr {QAT_MAP_LR}, step losses "
          f"{[round(x, 4) for x in torch.stack(losses).tolist()]}; engine "
          f"loss {l0:.5f} -> {l1:.5f}; int8 mAP@.5 {before:.4f} -> "
          f"{after:.4f} (bound: drop <= 0.15)")
    if not l1 < l0:
        raise AssertionError(f"QAT did not lower the engine's loss: {l0} -> "
                             f"{l1}")
    if not after >= before - 0.15:
        raise AssertionError(f"QAT: int8 mAP@.5 {before} -> {after}")


def _v1_served(infer, model, images, units: bool = True):
    """Call ``infer(images)`` with forward hooks on ``model`` and return
    what that call computed: ``{name: (input, output)}`` for
    ``"backbone"`` (images, features), ``""`` (images, head) and, with
    ``units``, every GoogLeNet conv unit (conv, BN, ReLU)."""
    from odc_tpu_torch.models.backbones.googlenet import BasicConv2d

    seen = {}

    def hook(name):
        def keep(module, args, out):
            seen[name] = (args[0], out)
        return keep

    hooks = [m.register_forward_hook(hook(n))
             for n, m in model.named_modules()
             if (units and isinstance(m, BasicConv2d))
             or n in ("", "backbone")]
    try:
        infer(images)
        sync()
    finally:
        for h in hooks:
            h.remove()
    return seen


def _v1_layer_errors(model32, seen):
    """Relative l2 error ||served - f32|| / ||f32|| of each served layer
    against the f32 model's same layer on the layer's served input: each
    GoogLeNet conv unit, and the Dense head (NHWC row-major flatten of the
    served features, Dense, ReLU, Dense) written out here in f32."""
    import torch.nn.functional as F

    def rel(got, ref):
        return float((got.float() - ref).norm() / ref.norm())

    units = dict(model32.named_modules())
    errs = {}
    with torch.no_grad():
        for name, (x, y) in seen.items():
            if name not in ("", "backbone"):
                errs[name] = rel(y, units[name](x.float()))
        feat = seen["backbone"][1].float()
        h = F.relu(F.linear(feat.reshape(feat.shape[0], -1),
                            model32.fc1.weight, model32.fc1.bias))
        y = seen[""][1]
        ref = F.linear(h, model32.fc2.weight, model32.fc2.bias)
        errs["dense head"] = rel(y, ref.reshape(y.shape))
    return errs


@contextlib.contextmanager
def _fp8_weights(model):
    """Every conv and Dense weight of ``model`` rounded to float8 e4m3 (one
    scale a tensor, max |w| -> 448; 3 mantissa bits against bf16's 7),
    restored on exit: the control of the v1 layer check."""
    saved = {n: p.detach().clone() for n, p in model.named_parameters()
             if p.dim() > 1}
    params = dict(model.named_parameters())
    try:
        with torch.no_grad():
            for n in saved:
                w = params[n]
                scale = w.abs().max() / 448.0
                w.copy_((w / scale).to(torch.float8_e4m3fn).float() * scale)
        yield
    finally:
        with torch.no_grad():
            for n, w in saved.items():
                params[n].copy_(w)


def phase_yolov1(counters):
    """The YOLOv1 path (serving and evaluation): YOLOv1-224 bf16 through
    ``make_infer_fn`` (GoogLeNet -> Dense head -> decode_v1 -> NMS), a batch
    of 8 at conf 0.9 and at a gap conf, then batch 512; ``Detector.detect``
    on two JPEGs and ``evaluate_batched`` on 64.  ``counters`` are the
    wrappers whose launch counts are zeroed just before the run and read
    just after: the NMS kernel once a call, no other.  Returns the
    launches by kernel and the batch-512 img/s."""
    from odc_tpu_torch.core.nms import sorted_candidates
    from odc_tpu_torch.eval import Detector, evaluate_batched
    from odc_tpu_torch.models import get_model
    from odc_tpu_torch.ops.cuda.nms_kernel import suppress, suppress_plain
    from odc_tpu_torch.ops.detect import make_infer_fn

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 20)
    requests = [
        torch.randint(0, 256, (b, *V1_HW, 3), generator=gen, dtype=torch.uint8)
        .to(DEVICE)
        for b in (8, V1_BATCH)
    ]
    model = get_model("YOLOv1", dtype=torch.bfloat16, device=DEVICE,
                      seed=SEED, **_v1_kwargs(V1_HW)).eval()
    _calibrate_bn(model, requests[0], torch.Generator().manual_seed(SEED + 21))
    infer = make_infer_fn(model, 0.9, 0.5, MAX_KEEP)
    # A runtime conf in the largest gap of the first request's confs (8 to
    # 48 survivors an image), from the model's own forward, which launches
    # no counted kernel.
    with torch.no_grad():
        conf0 = model.decode(model(requests[0])).conf
    n0 = requests[0].shape[0]
    gap_thre = _gap_threshold(conf0, 8 * n0, 48 * n0)
    sync()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"YOLOv1-{V1_HW[0]} built ({n_params} parameters), BN calibrated "
          f"in {time.perf_counter() - t0:.1f} s")

    calls = ([(requests[0], 0.9), (requests[0], gap_thre)]
             + [(requests[1], 0.9)] * (3 + TIMED_CALLS))
    once = {name: int(name == "nms_suppress") for name in counters}
    for wrapper in counters.values():
        wrapper.launches = 0
    torch.cuda.reset_peak_memory_stats()
    outs, call_ms = [], []
    for i, (images, conf_thre) in enumerate(calls):
        before = {k: w.launches for k, w in counters.items()}
        t = time.perf_counter()
        out = infer(images, conf_thre=conf_thre)
        sync()
        if i >= len(calls) - TIMED_CALLS:
            call_ms.append((time.perf_counter() - t) * 1e3)
        step = {k: w.launches - before[k] for k, w in counters.items()}
        if step != once:
            raise AssertionError(f"v1 call {i}: launches {step}, want {once}")
        if i < 3:
            outs.append((images, conf_thre, out))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: w.launches for k, w in counters.items()}
    print(f"YOLOv1 path: {len(calls)} calls, launches {launches}")
    for images, conf_thre, (boxes, conf, cls, keep) in outs:
        b = images.shape[0]
        if not (boxes.shape == (b, MAX_KEEP, 4) and conf.shape == (b, MAX_KEEP)
                and cls.shape == (b, MAX_KEEP, model.num_cls)
                and keep.shape == (b, MAX_KEEP)):
            raise AssertionError("v1: unexpected output shapes")
        if not all(bool(torch.isfinite(t).all()) for t in (boxes, conf, cls)):
            raise AssertionError("v1: non-finite outputs")
        if bool((conf[keep] < conf_thre).any()):
            raise AssertionError("v1: a kept box is below the conf threshold")
        print(f"v1 batch {b} at conf {conf_thre:.6f}: kept per image "
              f"{keep.sum(1).tolist()[:16]}{' ...' if b > 16 else ''}")
    if not bool(outs[1][2][3].any()):
        raise AssertionError("v1: the gap threshold kept no box")
    med = statistics.median(call_ms)
    q = statistics.quantiles(call_ms, n=4)
    img_s = V1_BATCH / med * 1e3
    print(f"YOLOv1-{V1_HW[0]} bf16 e2e, batch {V1_BATCH}, images on the card: "
          f"median {med:.3f} ms/call (quartiles {q[0]:.3f} / {q[2]:.3f}, n="
          f"{len(call_ms)}) -> {img_s:.1f} img/s; peak device memory "
          f"{peak_gb:.2f} GB")
    # Input: the call up to GoogLeNet; the Dense head includes the cast of
    # its f32 weights to bf16 (822 MB read a call).
    _layer_breakdown(infer, requests[1], [
        (model.backbone, "pre", "input"), (model.backbone, "post", "backbone"),
        (model, "post", "dense head")])
    _profile(lambda: infer(requests[1]))

    # The served path layer by layer: each GoogLeNet conv unit and the
    # Dense head, taken from an ``infer`` call on 16 images, against the
    # f32 model's same layer on the same served input.  The whole bf16
    # model is not held to the f32 model: a random BN-calibrated network
    # amplifies a relative error about 1.2x an inception block, so bf16
    # rounding reaches tens of percent at the head (printed below).
    # Bounds: u = 2^-8 is bf16's unit roundoff.  The Dense head rounds its
    # weights, the fc1 output and y, each within u: 4u = 2^-6.  A conv
    # unit's weight rounding is relative to |w||x|, and after a max pool
    # an input's mean is up to 4x its spread over samples, which the BN
    # turns into up to 4x the relative error: 8u = 2^-5.  The control runs
    # the same check with every weight rounded to fp8 e4m3 (u = 2^-4) and
    # must fail it.
    model32 = get_model("YOLOv1", dtype=torch.float32, device=DEVICE,
                        seed=SEED, **_v1_kwargs(V1_HW))
    model32.load_state_dict(model.state_dict())
    model32.eval()
    images = requests[1][:16]
    bounds = {"dense head": 2.0 ** -6, "conv": 2.0 ** -5}

    def worst(errs):
        convs = {k: v for k, v in errs.items() if k != "dense head"}
        name = max(convs, key=convs.get)
        return errs["dense head"], name, convs[name], len(convs)

    seen = _v1_served(infer, model, images)
    dense, conv_name, conv, n_units = worst(_v1_layer_errors(model32, seen))
    with torch.no_grad():
        y_f32 = model32(images)
    y16 = seen[""][1]
    e2e = float((y16 - y_f32).norm() / y_f32.norm())
    del seen
    with _fp8_weights(model):
        c_dense, c_name, c_conv, _ = worst(_v1_layer_errors(
            model32, _v1_served(infer, model, images)))
    del model32
    print(f"v1 served layers vs f32 on the served inputs (relative l2, 16 "
          f"images): dense head {dense:.5f} (bound {bounds['dense head']:.5f}"
          f"), worst of {n_units} conv units {conv:.5f} at "
          f"{conv_name} (bound {bounds['conv']:.5f}); control, fp8 e4m3 "
          f"weights: dense head {c_dense:.5f}, worst conv {c_conv:.5f} at "
          f"{c_name}; whole bf16 model vs f32 model {e2e:.5f} (max |y| "
          f"{float(y_f32.abs().max()):.4f})")
    if not (dense <= bounds["dense head"] and conv <= bounds["conv"]):
        raise AssertionError("v1: a served layer left the bf16 bound")
    if not (c_dense > bounds["dense head"] and c_conv > bounds["conv"]):
        raise AssertionError("v1: the fp8 control passed the layer check, "
                             "which cannot tell bf16 from fp8")
    if not bool(torch.isfinite(y16).all()):
        raise AssertionError("v1: non-finite served head")

    # NMS on the path's own candidates (the head of a batch-512 ``infer``
    # call): kernel == plain, at the product threshold and at a gap one;
    # then timed at this shape.
    y_serve = _v1_served(infer, model, requests[1], units=False)[""][1]
    det = model.decode(y_serve)
    boxes = det.boxes.reshape(V1_BATCH, -1, 4)
    conf = det.conf.reshape(V1_BATCH, -1)
    for thr in (0.9, _gap_threshold(conf, 8 * V1_BATCH, 48 * V1_BATCH)):
        _, cand, surv = sorted_candidates(boxes, conf, conf >= thr, MAX_KEEP)
        keep = suppress(cand, surv, 0.5)
        if not torch.equal(keep, suppress_plain(cand, surv, 0.5)):
            raise AssertionError(f"v1: NMS kernel != plain at conf {thr}")
        print(f"v1 candidates [{V1_BATCH}, {MAX_KEEP}], conf {thr:.6f}: "
              f"{int(surv.sum())} survivors, {int(keep.sum())} kept "
              f"(kernel == plain)")
    nms_ms = graph_ms(lambda: suppress(cand, surv, 0.5), 100)
    nms_plain_ms = graph_ms(lambda: suppress_plain(cand, surv, 0.5), 5)
    print(f"nms B={V1_BATCH} K={MAX_KEEP} on v1 candidates, device time per "
          f"call in a CUDA graph: kernel {nms_ms:.4f} ms, plain "
          f"{nms_plain_ms:.4f} ms")

    with tempfile.TemporaryDirectory() as root:
        dataset = _voc_val(EVAL_SIZES, root)
        det = Detector(model, conf_thre=0.05)
        # The first image of the set is 375x500, image 22 is 500x375.
        for index in (0, EVAL_SIZES[0][2]):
            _, img, _ = dataset[index]
            h, w = img.shape[:2]
            before = suppress.launches
            pred = det.detect(img)
            boxes = np.asarray(pred["bbox_list"]).reshape(-1, 4)
            if suppress.launches != before + 1:
                raise AssertionError("v1 detect: not one NMS launch")
            if not (np.isfinite(boxes).all() and (boxes >= 0).all()
                    and (boxes[:, 0::2] <= w).all()
                    and (boxes[:, 1::2] <= h).all()
                    and len(pred["lbl_list"]) == len(boxes)):
                raise AssertionError(f"v1 detect at {h}x{w}: boxes outside "
                                     "the image or malformed")
            print(f"Detector(YOLOv1).detect {h}x{w}: {len(boxes)} boxes in "
                  f"the image frame")
        for run in range(2):  # the first run meets new shapes
            before = suppress.launches
            t = time.perf_counter()
            result = evaluate_batched(det, dataset, image_hw=V1_HW,
                                      batch_size=64)
            wall = time.perf_counter() - t
            m50, m5095 = _map_scores(result, det.cls_list)
            print(f"eval evaluate_batched YOLOv1 {V1_HW[0]}x{V1_HW[1]} b64 "
                  f"run {run + 1}: "
                  f"{len(dataset)} images, {len(dataset) / wall:.1f} img/s "
                  f"(host JPEG decode and resize included); mAP@.5 "
                  f"{m50:.4f}, mAP[.5:.95] {m5095:.4f}; NMS launches "
                  f"{suppress.launches - before}")
            if suppress.launches == before:
                raise AssertionError("v1 evaluate_batched: no NMS launch")
    return launches, img_s


# YOLOv3 path: YOLOv3-416 (Darknet-53, FPN, 9 anchors), served at batch 256
# (the first batch of the JAX package's bench_yolov3), 10647 candidates an
# image; 32 int8 convs a call with int8_dynamic; trained at TRAIN_BATCH.
V3_HW = (416, 416)
V3_BATCH = 256
V3_INT8_LAYERS = 32
# Relative l2 bound of each served int8 layer against its f32 counterpart
# (see phase_yolov3).
V3_INT8_BOUND = 2.0 ** -4


def _int8_blocks(model):
    """{name: ConvBnLeaky} of the 3x3 convs that ``int8_dynamic`` runs in
    int8 (at least 128 input channels)."""
    from odc_tpu_torch.models.layers import ConvBnLeaky

    return {n: m for n, m in model.named_modules()
            if isinstance(m, ConvBnLeaky) and m.int8_dynamic
            and m.conv.kernel_size == (3, 3) and m.conv.in_channels >= 128}


def _v3_served(infer, model, images):
    """Call ``infer(images)`` with forward hooks and return what that call
    computed: ``{name: (input, output)}`` of each int8 layer and ``""``
    (images, heads)."""
    seen = {}
    mods = dict(_int8_blocks(model))
    mods[""] = model
    hooks = [m.register_forward_hook(
        lambda mod, args, out, n=n: seen.__setitem__(n, (args[0], out)))
        for n, m in mods.items()]
    try:
        infer(images)
        sync()
    finally:
        for h in hooks:
            h.remove()
    return seen


@contextlib.contextmanager
def _four_bit_codes():
    """Dynamic quantization to 4-bit codes (clamp +-7, step amax / 7) in
    place of int8's: the control of the v3 int8 layer check."""
    from odc_tpu_torch.ops import quantize

    real = quantize.quantize_dynamic

    def q4(x):
        xf = x.float()
        scale = xf.abs().amax().clamp_min(1e-8) / 7.0
        return torch.clamp(torch.round(xf / scale), -7, 7).to(torch.int8), \
            scale

    quantize.quantize_dynamic = q4
    try:
        yield
    finally:
        quantize.quantize_dynamic = real


def _v3_layer_errors(model32, seen):
    """Relative l2 ||served - f32|| / ||f32|| of each served int8 layer
    against the f32 model's same ConvBnLeaky on the layer's served input."""
    mods = dict(model32.named_modules())
    errs = {}
    with torch.no_grad():
        for name, (x, y) in seen.items():
            if name:
                ref = mods[name](x.float())
                errs[name] = float((y.float() - ref).norm() / ref.norm())
    return errs


def _serve_v3(label, model, requests, counters, gemms):
    """YOLOv3 serving through ``make_infer_fn``: a batch of 8 at conf 0.9
    and at a gap conf, then 23 batches of 256, each call checked for 1 NMS
    launch, no superstem and ``gemms`` GEMM launches, all on the wgmma
    route; then times, memory, the layer breakdown and the profile.
    Returns (launches, ms per call, img/s, gap threshold)."""
    from odc_tpu_torch.ops.detect import make_infer_fn

    infer = make_infer_fn(model, 0.9, 0.5, MAX_KEEP)
    with torch.no_grad():  # launches no counted kernel before the zeroing
        conf0 = model.decode(model(requests[0])).conf
    n0 = requests[0].shape[0]
    gap_thre = _gap_threshold(conf0, 8 * n0, 48 * n0)
    calls = ([(requests[0], 0.9), (requests[0], gap_thre)]
             + [(requests[1], 0.9)] * (3 + TIMED_CALLS))
    once = {name: int(name == "nms_suppress") for name in counters}
    once["int8_matmul"] = gemms
    mm = counters["int8_matmul"]
    for wrapper in counters.values():
        wrapper.launches = 0
    mm.launches_by_route = dict.fromkeys(mm.launches_by_route, 0)
    torch.cuda.reset_peak_memory_stats()
    outs, call_ms = [], []
    for i, (images, conf_thre) in enumerate(calls):
        before = {k: w.launches for k, w in counters.items()}
        t = time.perf_counter()
        out = infer(images, conf_thre=conf_thre)
        sync()
        if i >= len(calls) - TIMED_CALLS:
            call_ms.append((time.perf_counter() - t) * 1e3)
        step = {k: w.launches - before[k] for k, w in counters.items()}
        if step != once:
            raise AssertionError(f"v3 {label} call {i}: launches {step}, "
                                 f"want {once}")
        if i < 3:
            outs.append((images, conf_thre, out))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: w.launches for k, w in counters.items()}
    if mm.launches_by_route != {"wgmma": gemms * len(calls), "mma_sync": 0}:
        raise AssertionError(f"v3 {label}: GEMM routes "
                             f"{mm.launches_by_route}")
    print(f"YOLOv3 {label} path: {len(calls)} calls, launches {launches}, "
          f"GEMM launches by route {mm.launches_by_route}")
    for images, conf_thre, (boxes, conf, cls, keep) in outs:
        b = images.shape[0]
        if not (boxes.shape == (b, MAX_KEEP, 4) and conf.shape == (b, MAX_KEEP)
                and cls.shape == (b, MAX_KEEP, model.num_cls)
                and keep.shape == (b, MAX_KEEP)):
            raise AssertionError(f"v3 {label}: unexpected output shapes")
        if not all(bool(torch.isfinite(t).all()) for t in (boxes, conf, cls)):
            raise AssertionError(f"v3 {label}: non-finite outputs")
        if bool((conf[keep] < conf_thre).any()):
            raise AssertionError(f"v3 {label}: a kept box is below the "
                                 "conf threshold")
        print(f"v3 {label} batch {b} at conf {conf_thre:.6f}: kept per image "
              f"{keep.sum(1).tolist()[:16]}{' ...' if b > 16 else ''}")
    if not bool(outs[1][2][3].any()):
        raise AssertionError(f"v3 {label}: the gap threshold kept no box")
    med = statistics.median(call_ms)
    q = statistics.quantiles(call_ms, n=4)
    img_s = V3_BATCH / med * 1e3
    print(f"YOLOv3-{V3_HW[0]} {label} e2e, batch {V3_BATCH}, images on the "
          f"card: median {med:.3f} ms/call (quartiles {q[0]:.3f} / "
          f"{q[2]:.3f}, n={len(call_ms)}) -> {img_s:.1f} img/s; peak device "
          f"memory {peak_gb:.2f} GB")
    _layer_breakdown(infer, requests[1], [
        (model.backbone, "post", "backbone"), (model, "post", "fpn+heads")],
        iters=3)
    _profile(lambda: infer(requests[1]), calls=2, also=("matmul_kernel",))
    return launches, infer, gap_thre, img_s


def _v3_nms_check(label, model, infer, images, gap_thre):
    """The NMS kernel against its plain version on the candidates of a
    batch-256 ``infer`` call (its heads, from a forward hook), at conf 0.9
    and at the gap conf; then timed at that shape."""
    from odc_tpu_torch.core.nms import sorted_candidates
    from odc_tpu_torch.ops.cuda.nms_kernel import suppress, suppress_plain

    seen = {}
    hook = model.register_forward_hook(
        lambda mod, args, out: seen.__setitem__("y", out))
    try:
        infer(images)
    finally:
        hook.remove()
    det = model.decode(seen.pop("y"))
    b = images.shape[0]
    boxes, conf = det.boxes.reshape(b, -1, 4), det.conf.reshape(b, -1)
    if conf.shape[1] != 10647:
        raise AssertionError(f"v3: {conf.shape[1]} candidates an image")
    for thr in (0.9, gap_thre):
        _, cand, surv = sorted_candidates(boxes, conf, conf >= thr, MAX_KEEP)
        keep = suppress(cand, surv, 0.5)
        if not torch.equal(keep, suppress_plain(cand, surv, 0.5)):
            raise AssertionError(f"v3 {label}: NMS kernel != plain at conf "
                                 f"{thr}")
        print(f"v3 {label} candidates [{b}, 10647] -> [{b}, {MAX_KEEP}], conf "
              f"{thr:.6f}: {int(surv.sum())} survivors, {int(keep.sum())} "
              f"kept (kernel == plain)")
    ms = graph_ms(lambda: suppress(cand, surv, 0.5), 100)
    plain_ms = graph_ms(lambda: suppress_plain(cand, surv, 0.5), 5)
    print(f"nms B={b} K={MAX_KEEP} on v3 candidates, device time per call "
          f"in a CUDA graph: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")


def _v3_gemm_check(infer, images):
    """Every GEMM of one ``int8_dynamic`` call at batch 256, recorded as it
    runs: on the wgmma route, bitwise equal to the plain version and to
    ``torch._int_mm``, timed (CUDA graphs) against its bound."""
    from odc_tpu_torch.ops.cuda.matmul_kernel import matmul_plain, route

    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes_ms=0.0,
               ops_ms=0.0, bound_ms=0.0)
    shapes = []

    def check(real, a, b):
        m, k = a.shape
        n = b.shape[1]
        got = real(a, b)
        if route(m, n, k, a.dtype, a, b) != "wgmma":
            raise AssertionError(f"v3 GEMM {len(shapes)}: not on wgmma")
        if not (torch.equal(got, matmul_plain(a, b))
                and torch.equal(torch._int_mm(a, b), got)):
            raise AssertionError(f"v3 GEMM {len(shapes)} M={m} K={k} N={n}: "
                                 "kernel, plain and _int_mm disagree")
        ms = graph_ms(lambda: real(a, b), 3)
        lib_ms = graph_ms(lambda: torch._int_mm(a, b), 3)
        plain_ms = time_ms(lambda: matmul_plain(a, b), 1, warmup=0)
        nbytes, ops = _mm_bound(m, k, n, 1, 4)
        bms, _ = bound_ms(nbytes, ops, INT8_OPS)
        for key, v in (("ms", ms), ("plain_ms", plain_ms),
                       ("library_ms", lib_ms), ("bound_ms", bms),
                       ("bytes_ms", nbytes / HBM_BPS * 1e3),
                       ("ops_ms", ops / INT8_OPS * 1e3)):
            tot[key] += v
        shapes.append((m, k, n, ms, lib_ms, bms))
        return got

    with _swap_matmul(check):
        infer(images)
    if len(shapes) != V3_INT8_LAYERS:
        raise AssertionError(f"v3: {len(shapes)} GEMMs in an int8 call")
    by_shape = {}
    for m, k, n, ms, lib_ms, bms in shapes:
        row = by_shape.setdefault((m, k, n), [0, 0.0, 0.0, 0.0])
        row[0] += 1
        row[1] += ms
        row[2] += lib_ms
        row[3] += bms
    for (m, k, n), (count, ms, lib_ms, bms) in sorted(by_shape.items()):
        print(f"  v3 GEMM M={m} K={k} N={n} x{count}: wgmma {ms:.4f} ms "
              f"({2.0 * m * k * n * count / ms / 1e9:.1f} TOPS), _int_mm "
              f"{lib_ms:.4f}, bound {bms:.4f}")
    print(f"v3 int8 GEMMs of one batch-{V3_BATCH} call (32, all wgmma, "
          f"bitwise equal to plain and _int_mm): kernel {tot['ms']:.3f} ms, "
          f"plain {tot['plain_ms']:.3f}, _int_mm {tot['library_ms']:.3f}, "
          f"bound {tot['bound_ms']:.4f} ms (operations {tot['ops_ms']:.4f}, "
          f"bytes {tot['bytes_ms']:.4f}; kernel at "
          f"{100 * tot['bound_ms'] / tot['ms']:.1f}% of it)")
    return tot


def phase_yolov3(counters):
    """The YOLOv3 path (serving and evaluation): YOLOv3-416 bf16 through
    ``make_infer_fn`` (Darknet-53 -> FPN -> three heads -> decode_v3 ->
    NMS), and the same model with ``int8_dynamic`` (32 int8 GEMMs a call);
    ``Detector.detect`` on two JPEGs and ``evaluate_batched`` on 64, both
    precisions.  ``counters`` are the wrappers whose launch counts are
    zeroed just before each serving run and read just after.  Returns the
    launches by kernel of both runs and their batch-256 img/s."""
    from odc_tpu_torch.eval import Detector, evaluate_batched
    from odc_tpu_torch.models import get_model
    from odc_tpu_torch.ops.cuda.nms_kernel import suppress

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 30)
    requests = [
        torch.randint(0, 256, (b, *V3_HW, 3), generator=gen, dtype=torch.uint8)
        .to(DEVICE)
        for b in (8, V3_BATCH)
    ]
    model = get_model("YOLOv3", dtype=torch.bfloat16, device=DEVICE,
                      seed=SEED, image_size=V3_HW).eval()
    _calibrate_bn(model, requests[0], torch.Generator().manual_seed(SEED + 31))
    model8 = get_model("YOLOv3", dtype=torch.bfloat16, device=DEVICE,
                       seed=SEED, image_size=V3_HW, int8_dynamic=True).eval()
    model8.load_state_dict(model.state_dict())
    if len(_int8_blocks(model8)) != V3_INT8_LAYERS:
        raise AssertionError("v3: not 32 int8 layers")
    sync()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"YOLOv3-{V3_HW[0]} built ({n_params} parameters), BN calibrated "
          f"in {time.perf_counter() - t0:.1f} s")

    launches, infer, gap_thre, img_s = _serve_v3(
        "bf16", model, requests, counters, 0)
    _v3_nms_check("bf16", model, infer, requests[1], gap_thre)
    del infer
    launches8, infer8, gap8, img_s8 = _serve_v3(
        "int8_dynamic", model8, requests, counters, V3_INT8_LAYERS)
    _v3_nms_check("int8_dynamic", model8, infer8, requests[1], gap8)
    gemm = _v3_gemm_check(infer8, requests[1])

    # Each int8 layer of a served call (forward hooks, 16 images) against
    # the f32 model's same layer on the same served input.  The bound: a
    # per-tensor int8 code rounds its input within half a step, amax / 127,
    # so by (amax / rms) / (127 sqrt 12) = 0.0023 (amax / rms) relative rms;
    # the per-channel weight codes add (sqrt 3) / (127 sqrt 12) = 0.004 for
    # uniformly drawn weights; BN scales the result by the channel's
    # |mean| / spread, and the bf16 output adds 2^-9.  2^-4 holds an
    # amax / rms up to 16 at a BN gain of 1.7.  The same check on the CPU
    # (tests/test_torch_yolov3.py::test_int8_layers_within_the_card_bound,
    # f32 at 64x64) measures 0.013-0.020, and 0.19-0.33 for the control,
    # the same check with 4-bit codes (step amax / 7): it must fail the
    # bound at every layer here too.
    model32 = get_model("YOLOv3", dtype=torch.float32, device=DEVICE,
                        seed=SEED, image_size=V3_HW)
    model32.load_state_dict(model.state_dict())
    model32.eval()
    images = requests[1][:16]
    seen = _v3_served(infer8, model8, images)
    errs = _v3_layer_errors(model32, seen)
    with torch.no_grad():
        y32 = model32(images)
    y8 = seen[""][1]
    head_err = [float((a - b).norm() / b.norm()) for a, b in zip(y8, y32)]
    ratio = max(float(x.float().abs().max() / x.float().pow(2).mean().sqrt())
                for n, (x, _) in seen.items() if n)
    del seen
    with _four_bit_codes():
        c_errs = _v3_layer_errors(model32, _v3_served(infer8, model8, images))
    del model32, y32, y8
    worst = max(errs, key=errs.get)
    c_best = min(c_errs, key=c_errs.get)
    print(f"v3 served int8 layers vs f32 on the served inputs (relative l2, "
          f"16 images): {len(errs)} layers, worst {errs[worst]:.5f} at "
          f"{worst}, median {statistics.median(errs.values()):.5f} (bound "
          f"{V3_INT8_BOUND:.5f}; largest input amax / rms {ratio:.2f}); "
          f"control, 4-bit codes: smallest {c_errs[c_best]:.5f} at {c_best}; "
          f"whole int8 heads vs f32 model (y32, y16, y8) "
          f"{[round(e, 5) for e in head_err]}")
    if len(errs) != V3_INT8_LAYERS or errs[worst] > V3_INT8_BOUND:
        raise AssertionError("v3: a served int8 layer left its bound")
    if c_errs[c_best] <= V3_INT8_BOUND:
        raise AssertionError("v3: the 4-bit control passed the layer check "
                             "at some layer")

    with tempfile.TemporaryDirectory() as root:
        dataset = _voc_val(EVAL_SIZES, root)
        for label, m in (("bf16", model), ("int8_dynamic", model8)):
            det = Detector(m, conf_thre=0.05)
            for index in (0, EVAL_SIZES[0][2]):
                _, img, _ = dataset[index]
                h, w = img.shape[:2]
                before = suppress.launches
                pred = det.detect(img)
                boxes = np.asarray(pred["bbox_list"]).reshape(-1, 4)
                if suppress.launches != before + 1:
                    raise AssertionError("v3 detect: not one NMS launch")
                if not (np.isfinite(boxes).all() and (boxes >= 0).all()
                        and (boxes[:, 0::2] <= w).all()
                        and (boxes[:, 1::2] <= h).all()
                        and len(pred["lbl_list"]) == len(boxes)):
                    raise AssertionError(f"v3 detect at {h}x{w}: boxes "
                                         "outside the image or malformed")
                print(f"Detector(YOLOv3 {label}).detect {h}x{w}: "
                      f"{len(boxes)} boxes in the image frame")
            for run in range(2):  # the first run meets new shapes
                before = suppress.launches
                t = time.perf_counter()
                result = evaluate_batched(det, dataset, image_hw=V3_HW,
                                          batch_size=64)
                wall = time.perf_counter() - t
                m50, m5095 = _map_scores(result, det.cls_list)
                print(f"eval evaluate_batched YOLOv3 {label} {V3_HW[0]}x"
                      f"{V3_HW[1]} b64 run {run + 1}: {len(dataset)} images, "
                      f"{len(dataset) / wall:.1f} img/s (host JPEG decode "
                      f"and resize included); mAP@.5 {m50:.4f}, mAP[.5:.95] "
                      f"{m5095:.4f}; NMS launches {suppress.launches - before}")
                if suppress.launches == before:
                    raise AssertionError("v3 evaluate_batched: no NMS launch")
    print(f"phase yolov3 (serving, checks, eval) took "
          f"{time.perf_counter() - t0:.1f} s")
    return launches, launches8, img_s, img_s8, gemm


# This slice's host data path and data parallelism (phases loader,
# host_augment, dp): the C++ loader against PIL on the eval JPEGs, a train
# epoch with host against device augmentation, and a one-rank NCCL group.
HOST_AUG_IMAGES = 128
HOST_AUG_HW = (375, 500)


def phase_loader(model, counters):
    """The port's C++ loader on this host: can it build (g++, jpeglib.h),
    in how many seconds; ``decode_resize_batch`` to 416x416 on the 64 eval
    JPEGs against PIL decode + resize on one thread; ``evaluate_batched``
    (YOLOv2 bf16, batch 64) with the loader against PIL.  A host without
    g++ or libjpeg runs the PIL figures alone (the JAX package degrades the
    same way).  Returns the launches of the evaluator runs."""
    import shutil
    from unittest import mock

    from odc_tpu_torch.eval import Detector, evaluate_batched
    from odc_tpu_torch.native import loader

    have = {"g++": shutil.which("g++") is not None,
            "jpeglib.h": any(os.path.exists(os.path.join(d, "jpeglib.h"))
                             for d in ("/usr/include", "/usr/local/include",
                                       "/usr/include/x86_64-linux-gnu"))}
    # The first decode of the run (phase native's eval) built the library
    # or failed to: time a fresh build into a temporary folder.
    res = {"host_has": have, "built": loader.available()}
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        try:
            loader.build(os.path.join(tmp, "lib.so"), force=True)
            res["build_s"] = time.perf_counter() - t
        except (OSError, subprocess.SubprocessError):
            res["build_s"] = None
    if not res["built"]:
        res["why"] = (loader.load_error or "")[-600:]
    launches = {k: 0 for k in counters}
    with tempfile.TemporaryDirectory() as root:
        dataset = _voc_val(EVAL_SIZES, root)
        n = len(dataset)
        paths = dataset.img_path_list
        from PIL import Image

        def pil_one(p):
            with Image.open(p) as im:
                img = np.asarray(im.convert("RGB"))
            return np.asarray(Image.fromarray(img).resize(
                (HW[1], HW[0]), Image.BILINEAR))

        t = time.perf_counter()
        for p in paths:
            pil_one(p)
        res["pil_decode_resize_img_s"] = n / (time.perf_counter() - t)
        if res["built"]:
            loader.decode_resize_batch(paths[:8], HW)  # warm-up
            rates = []
            for _ in range(3):
                t = time.perf_counter()
                imgs, _ = loader.decode_resize_batch(paths, HW)
                rates.append(n / (time.perf_counter() - t))
            res["loader_batch_img_s"] = statistics.median(rates)
            res["loader_threads"] = os.cpu_count()
            t = time.perf_counter()
            for p in paths:
                loader.decode_resize_jpeg(p, HW)
            res["loader_one_thread_img_s"] = n / (time.perf_counter() - t)
            ref = np.stack([loader.resize_bilinear(loader.decode_jpeg(p), HW)
                            for p in paths])
            if not np.array_equal(imgs, ref):
                raise AssertionError("loader: batch != per-image decode + "
                                     "resize")
        det = Detector(model, conf_thre=0.05)
        modes = [("pil", False)]
        if res["built"]:
            modes.append(("loader", True))
        scores = {}
        for name, on in modes:
            with mock.patch.object(loader, "available", lambda on=on: on):
                walls = []
                for _ in range(2):  # the first run meets new shapes
                    before = {k: w.launches for k, w in counters.items()}
                    t = time.perf_counter()
                    result = evaluate_batched(det, dataset, image_hw=HW,
                                              batch_size=BATCH)
                    walls.append(time.perf_counter() - t)
                    for k, w in counters.items():
                        launches[k] += w.launches - before[k]
            scores[name] = _map_scores(result, det.cls_list)
            res[f"evaluate_batched_{name}_img_s"] = [n / w for w in walls]
        res["map50"] = {k: v[0] for k, v in scores.items()}
    print(json.dumps({"phase": "loader", **res}))
    if launches["nms_suppress"] == 0:
        raise AssertionError("loader: evaluate_batched launched no NMS")
    return launches


def phase_host_augment(counters):
    """A YOLOv2-416 bf16 Trainer epoch at batch 32 on synthetic VOC JPEGs
    (375x500) with the reference-order host augmentation against the
    in-step device augmentation: ms/step of a timed epoch after a warm-up
    one, and the device's busy share in a third, profiled epoch.  The
    pipeline decodes and resizes on its prefetch thread in both.  Returns
    the launches of the timed epochs."""
    import dataclasses

    from odc_tpu_torch.config import TRAIN_CONFIG
    from odc_tpu_torch.data.host_augment import reference_augment
    from odc_tpu_torch.data.pipeline import DetectionPipeline
    from odc_tpu_torch.data.voc import VOC, make_synthetic_voc
    from odc_tpu_torch.models import get_model
    from odc_tpu_torch.ops.augment import AugmentConfig
    from odc_tpu_torch.train.trainer import Trainer

    res, launches = {}, {k: 0 for k in counters}
    config = dataclasses.replace(
        TRAIN_CONFIG["YOLOv2"]["VOC2012"], learning_rate_list=[1e-3],
        num_epoch_list=[1], batch_size=TRAIN_BATCH, momentum=0.9,
        multiscale_sizes=(), seed=SEED)
    with tempfile.TemporaryDirectory() as root:
        make_synthetic_voc(root, num_train=HOST_AUG_IMAGES, num_val=0,
                           image_hw=HOST_AUG_HW, seed=SEED)
        voc = VOC(dataset_dir=root)
        for name in ("host", "device"):
            pipe = DetectionPipeline(
                voc.train_dataset, HW, TRAIN_BATCH, config.max_boxes,
                seed=SEED,
                augment=reference_augment if name == "host" else None)
            model = get_model("YOLOv2", dtype=torch.bfloat16, device=DEVICE,
                              seed=SEED, image_size=HW)
            trainer = Trainer(
                model, pipe, None, config, os.path.join(root, name),
                augment_cfg=AugmentConfig() if name == "device" else None)
            state = trainer.init_state()
            trainer.run_train_epoch(state, 1)  # warm-up
            for w in counters.values():
                w.launches = 0
            t = time.perf_counter()
            trainer.run_train_epoch(state, 1)
            sync()
            wall = time.perf_counter() - t
            for k, w in counters.items():
                launches[k] += w.launches
            steps = len(pipe)
            res[name] = {"ms_per_step": 1e3 * wall / steps, "steps": steps,
                         "warp_launches": counters["warp_affine"].launches}
            # The busy share from a third epoch under the profiler (which
            # adds host time of its own).
            res[name]["device_busy_pct"] = _profile(
                lambda: trainer.run_train_epoch(state, 1), calls=1)
            want = steps if name == "device" else 0
            if res[name]["warp_launches"] != want:
                raise AssertionError(f"host_augment {name}: warp launches "
                                     f"{res[name]['warp_launches']}, want "
                                     f"{want}")
            del model, trainer, state
            torch.cuda.empty_cache()
    res["host_over_device"] = (res["host"]["ms_per_step"]
                               / res["device"]["ms_per_step"])
    print(json.dumps({"phase": "host_augment", **res}))
    return launches


def phase_dp(counters):
    """A one-rank NCCL group (``tcp://127.0.0.1``, world size 1): the
    data-parallel train step (BN statistics over the group, global loss
    counts, the one-bucket gradient all-reduce, global-batch augmentation
    draws) of YOLOv2-416 at batch 32 with device augmentation, against the
    plain step from the same state and batch: the f32 losses within rtol
    1e-5; then bf16 ms/step of both and the all-reduce's own device time.
    A failed NCCL init or collective fails the run.  Returns the launches
    of the timed data-parallel steps."""
    import socket

    import torch.distributed as dist

    from odc_tpu_torch.parallel import (
        all_reduce_grads, maybe_initialize_distributed,
    )

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dp = maybe_initialize_distributed(
        device=DEVICE, init_method=f"tcp://127.0.0.1:{port}", world_size=1,
        rank=0)
    res = {"backend": dist.get_backend(), "world_size": dp.world_size,
           "device": str(dp.device)}
    try:
        if res["backend"] != "nccl":
            raise AssertionError(f"dp: backend {res['backend']}, not nccl")
        batch = _one_batch(dp.rank, dp.world_size)
        losses = {}
        for use_dp in (False, True):
            state, step, gen = _v2_step(torch.float32,
                                        dp=dp if use_dp else None)
            _, metrics = step(state, batch, 1e-3, gen)
            losses[use_dp] = float(metrics["loss"])
            del state, step
        rel = abs(losses[True] - losses[False]) / abs(losses[False])
        res["f32_loss_plain"], res["f32_loss_dp"] = losses[False], losses[True]
        res["f32_loss_rel_diff"] = rel
        if not rel <= 1e-5:
            raise AssertionError(f"dp: loss {losses[True]} vs plain "
                                 f"{losses[False]} (rel {rel:.2e} > 1e-5)")
        torch.cuda.empty_cache()

        for use_dp in (False, True):
            state, step, gen = _v2_step(torch.bfloat16,
                                        dp=dp if use_dp else None)
            ms, _, launches = _timed_steps(state, step, batch, gen,
                                           counters, TIMED_STEPS)
            res["bf16_ms_per_step_" + ("dp" if use_dp else "plain")] = ms
            if use_dp:
                params = list(state.model.parameters())
                res["grad_bucket_mb"] = sum(
                    p.numel() for p in params) * 4 / 1e6
                res["all_reduce_ms"] = time_ms(
                    lambda: all_reduce_grads(params, dp), TIMED_STEPS)
            del state, step
            torch.cuda.empty_cache()
        if launches["warp_affine"] != TIMED_STEPS:
            raise AssertionError(f"dp: warp launches {launches}, want "
                                 f"{TIMED_STEPS}")
    finally:
        dist.destroy_process_group()
    print(json.dumps({"phase": "dp", **res}))
    return launches


# This slice's phases (remat, mp, probe): the rematerialized YOLOv2
# training step, the mesh's model axis in two processes on the one card,
# and YOLOv3's prefix probes with a profiler trace.
MP_STEPS = 5
PROBE_ITERS = 3


def _first(pipe):
    """The first batch of ``pipe``, on the card (its prefetch thread
    stopped)."""
    from odc_tpu_torch.data.prefetch import device_prefetch

    batches = device_prefetch(pipe, torch.device(DEVICE))
    batch = next(batches)
    batches.close()
    return batch


def _one_batch(rank=0, world=1):
    """The data-parallel phases' batch: 32 rectangles-on-noise images at
    416x416 through the pipeline (the data index's rows), on the card."""
    from odc_tpu_torch.data.pipeline import DetectionPipeline

    data = _RectanglesOnNoise(TRAIN_BATCH, HW, SEED + 9)
    return _first(DetectionPipeline(data, HW, TRAIN_BATCH, 64, seed=SEED,
                                    process_index=rank, process_count=world))


def _v2_step(dtype, remat=False, dp=None, shard=False):
    """A YOLOv2-416 train state and step (momentum 0.9, device
    augmentation, ``dp``'s mesh; ``shard``: the model's wide kernels
    sharded over its model axis) and its augmentation generator."""
    from odc_tpu_torch.losses.yolo_loss import Lambdas
    from odc_tpu_torch.models import get_model
    from odc_tpu_torch.ops.augment import AugmentConfig
    from odc_tpu_torch.parallel import broadcast_state, shard_model
    from odc_tpu_torch.train.trainer import TrainState, make_train_step

    model = get_model("YOLOv2", dtype=dtype, device=DEVICE, seed=SEED,
                      image_size=HW, remat=remat)
    if shard:
        shard_model(model, dp)
    state = TrainState(model)
    if dp is not None:
        broadcast_state(state, dp)
    step = make_train_step("v2", Lambdas(), model.anchors, momentum=0.9,
                           augment_cfg=AugmentConfig(), dp=dp)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    return state, step, gen


def _timed_steps(state, step, batch, gen, counters, steps):
    """Median ms/step over ``steps`` steps after two warm-up steps, the
    ``Throughput`` meter's img/s over them, and the kernels' launches in
    the timed steps (counts zeroed just before, read just after)."""
    from odc_tpu_torch.utils import Throughput

    for _ in range(2):
        step(state, batch, 1e-3, gen)
    sync()
    meter = Throughput()
    for w in counters.values():
        w.launches = 0
    times = []
    meter.start()
    for _ in range(steps):
        t = time.perf_counter()
        step(state, batch, 1e-3, gen)
        sync()
        times.append((time.perf_counter() - t) * 1e3)
        meter.update(batch.image.shape[0])
    launches = {k: w.launches for k, w in counters.items()}
    return statistics.median(times), meter.images_per_sec, launches


def phase_remat(counters):
    """``YOLOv2(remat=True)``: the YOLOv2-416 train step at batch 32 with
    device augmentation, with and without remat, from one init and one
    batch.  f32: the losses within rtol 1e-5 and the BN running statistics
    after the step equal (the recomputation must not move them again).
    bf16: ms/step, peak device memory and img/s (``Throughput``) of both.
    Returns the kernels' launches of the timed bf16 steps of both."""
    res = {}
    batch = _one_batch()
    stats = {}
    for remat in (False, True):
        state, step, gen = _v2_step(torch.float32, remat)
        _, metrics = step(state, batch, 1e-3, gen)
        res[f"f32_loss_{'remat' if remat else 'plain'}"] = float(
            metrics["loss"])
        stats[remat] = {k: v.clone() for k, v in state.model.named_buffers()}
        del state, step
        torch.cuda.empty_cache()
    plain, remat = res["f32_loss_plain"], res["f32_loss_remat"]
    res["f32_loss_rel_diff"] = abs(remat - plain) / abs(plain)
    differ = [k for k, v in stats[False].items()
              if not torch.equal(v, stats[True][k])]
    res["running_stats_differ"] = len(differ)
    if not res["f32_loss_rel_diff"] <= 1e-5:
        raise AssertionError(f"remat: f32 loss {remat} vs {plain}")
    if differ:
        raise AssertionError(f"remat: running statistics differ: "
                             f"{differ[:4]}")
    launches = {k: 0 for k in counters}
    for remat in (False, True):
        label = "remat" if remat else "plain"
        state, step, gen = _v2_step(torch.bfloat16, remat)
        sync()
        torch.cuda.reset_peak_memory_stats()
        ms, img_s, got = _timed_steps(state, step, batch, gen, counters,
                                      TIMED_STEPS)
        res[f"bf16_ms_per_step_{label}"] = ms
        res[f"bf16_img_s_{label}"] = img_s
        res[f"peak_gb_{label}"] = torch.cuda.max_memory_allocated() / 1e9
        if got["warp_affine"] != TIMED_STEPS:
            raise AssertionError(f"remat: warp launches {got}")
        _add(launches, got)
        del state, step
        torch.cuda.empty_cache()
    print(json.dumps({"phase": "remat", **res}))
    return launches


def _mp_worker(rank, port, out_dir):
    """One rank of phase mp (a spawned process): a (1, 2) mesh over gloo
    with both ranks on ``cuda:0``."""
    import torch.distributed as dist

    from odc_tpu_torch.ops.cuda.warp_kernel import warp_affine
    from odc_tpu_torch.parallel import make_mesh, maybe_initialize_distributed

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"rank": rank}
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    try:
        dp = make_mesh(maybe_initialize_distributed(device=DEVICE), 2)
        res["backend"] = dist.get_backend()
        res["mesh"] = [dp.world_size, dp.model_size]
        batch = _one_batch(dp.rank, dp.world_size)
        if dp.is_writer:  # the one-process step, from the same init
            state, step, gen = _v2_step(torch.float32)
            before = {n: p.detach().clone()
                      for n, p in state.model.named_parameters()}
            _, metrics = step(state, batch, 1e-3, gen)
            res["f32_loss_plain"] = float(metrics["loss"])
            want = {n: p.detach() - before[n]
                    for n, p in state.model.named_parameters()}
            del state, step
        state, step, gen = _v2_step(torch.float32, dp=dp, shard=True)
        res["sharded_params"] = sum(
            getattr(m, "model_shard", None) is not None
            for m in state.model.modules())
        _, metrics = step(state, batch, 1e-3, gen)
        res["f32_loss_mp"] = float(metrics["loss"])
        after = state.state_dict()["model"]  # gathered
        if dp.is_writer:
            num = den = 0.0
            worst = (0.0, "")
            for n, w in want.items():
                d = float((after[n] - before[n] - w).norm())
                num += d * d
                den += float(w.norm()) ** 2
                worst = max(worst, (d / max(float(w.norm()), 1e-30), n))
            res["f32_update_rel_l2"] = (num / den) ** 0.5
            res["f32_update_worst_leaf"] = list(worst)
            del want, before
        del state, step, after
        torch.cuda.empty_cache()
        state, step, gen = _v2_step(torch.bfloat16, dp=dp, shard=True)
        torch.cuda.reset_peak_memory_stats()
        ms, img_s, launches = _timed_steps(
            state, step, batch, gen, {"warp_affine": warp_affine}, MP_STEPS)
        res.update(bf16_ms_per_step=ms, bf16_img_s=img_s,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   launches=launches)
    finally:
        dist.destroy_process_group()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)


def phase_mp(counters):
    """The mesh's model axis (``--model-parallel 2``): YOLOv2-416 at batch
    32 with device augmentation on a (data 1, model 2) mesh of two
    processes sharing the one card over gloo (NCCL refuses two ranks on one
    device; gloo stages every collective through the host).  f32: the loss
    within rtol 1e-5 of the one-process step's and the gathered update
    within relative l2 1e-2 of its update; bf16: ms/step, which measures
    this staging, not model parallelism's speed.  Returns the warp's
    launches in both ranks' timed steps."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as out_dir:
        procs = [ctx.Process(target=_mp_worker, args=(r, port, out_dir))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(600)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        ranks = []
        for r in range(2):
            path = os.path.join(out_dir, f"rank{r}.json")
            ranks.append(json.load(open(path)) if os.path.exists(path)
                         else {})
    print(json.dumps({"phase": "mp", "ranks": ranks,
                      "note": "bf16 ms/step of two processes on one card "
                      "over gloo (host-staged collectives): not a measure "
                      "of model parallelism's speed"}))
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"mp: worker exit codes "
                             f"{[p.exitcode for p in procs]}")
    r0 = ranks[0]
    rel = abs(r0["f32_loss_mp"] - r0["f32_loss_plain"]) / abs(
        r0["f32_loss_plain"])
    if not rel <= 1e-5:
        raise AssertionError(f"mp: loss {r0['f32_loss_mp']} vs "
                             f"{r0['f32_loss_plain']} (rel {rel:.2e})")
    if not r0["f32_update_rel_l2"] <= 1e-2:
        raise AssertionError(f"mp: update rel l2 {r0['f32_update_rel_l2']}")
    if ranks[1]["f32_loss_mp"] != r0["f32_loss_mp"]:
        raise AssertionError("mp: the ranks report different losses")
    launches = {k: 0 for k in counters}
    for r in ranks:
        if r["launches"]["warp_affine"] != MP_STEPS:
            raise AssertionError(f"mp: warp launches {r['launches']}")
        _add(launches, r["launches"])
    return launches


QAT_MP_STEPS = 3
# The engine's stop_after points: backbone convs 0-19, the neck input (21),
# the neck output (22); None runs to the head.
ENGINE_STOPS = (*range(20), 21, 22, None)


def _crc(t: torch.Tensor) -> int:
    import zlib

    return zlib.crc32(np.ascontiguousarray(t.detach().cpu().numpy()))


@contextlib.contextmanager
def _mesh_split_twin(model_size: int):
    """Inside the block, an unsharded model's QAT twin convolves each
    conv the mesh shards (at least 512 outputs) as the model axis does:
    each rank's slice of output channels on its own, the results
    concatenated.  cuDNN picks its f32 algorithm by the output width, so a
    slice sums in another order than the whole conv; fake quantization
    turns that into flipped codes, which a calibrated random network
    amplifies layer by layer.  With the same splits one card sums as the
    mesh does, and the sharded step can be held to it."""
    from odc_tpu_torch.ops import qat as tq
    from odc_tpu_torch.ops.int8_engine import _conv_f32
    from odc_tpu_torch.parallel.mesh import _MIN_SHARD_CHANNELS

    real = tq._twin_conv

    def split(shard, h, kernel):
        if shard is not None or kernel.shape[-1] < _MIN_SHARD_CHANNELS:
            return real(shard, h, kernel)
        return torch.cat([_conv_f32(h, tq.fake_quant_weight(k)) for k in
                          kernel.tensor_split(model_size, dim=-1)], -1)

    tq._twin_conv = split
    try:
        yield
    finally:
        tq._twin_conv = real


def _qat_mp_worker(rank, port, out_dir):
    """One rank of phase qat_mp (a spawned process): a (1, 2) mesh over
    gloo with both ranks on ``cuda:0``.  Global rank 0 also holds a
    one-card copy of the model, taken before sharding, for the gates; the
    other rank waits in the next collective meanwhile."""
    import copy
    import dataclasses

    import torch.distributed as dist

    from odc_tpu_torch.config import TRAIN_CONFIG
    from odc_tpu_torch.data.pipeline import DetectionPipeline
    from odc_tpu_torch.losses.yolo_loss import Lambdas
    from odc_tpu_torch.models.yolov2 import YOLOv2
    from odc_tpu_torch.ops import int8_engine as te
    from odc_tpu_torch.ops.augment import AugmentConfig
    from odc_tpu_torch.ops.cuda.matmul_kernel import (
        matmul, matmul_plain, route,
    )
    from odc_tpu_torch.ops.cuda.warp_kernel import warp_affine
    from odc_tpu_torch.ops.qat import make_qat_train_step, yolov2_qat_forward
    from odc_tpu_torch.parallel import (
        make_mesh, maybe_initialize_distributed, model_shards, shard_model,
    )
    from odc_tpu_torch.parallel.mesh import shard_of
    from odc_tpu_torch.train import (
        calibrate_from_pipeline, checkpoint, finetune_qat,
    )
    from odc_tpu_torch.train.qat import make_engine_eval_step
    from odc_tpu_torch.train.trainer import TrainState

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {"rank": rank}
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    try:
        t0 = time.perf_counter()
        dp = make_mesh(maybe_initialize_distributed(device=DEVICE), 2)
        writer = dp.is_writer
        res["mesh"] = [dp.world_size, dp.model_size]
        cfg = dataclasses.replace(TRAIN_CONFIG["YOLOv2"]["VOC2012"],
                                  seed=SEED)
        lambdas = Lambdas(cfg.lambda_xy, cfg.lambda_wh, cfg.lambda_conf,
                          cfg.lambda_noobj, cfg.lambda_cls)
        train_set = _RectanglesOnNoise(TRAIN_IMAGES, HW, SEED + 7)
        rows = dict(process_index=dp.rank, process_count=dp.world_size)
        train_pipe = DetectionPipeline(
            train_set, HW, TRAIN_BATCH, cfg.max_boxes, mode="v2", seed=SEED,
            **rows)
        val_pipe = DetectionPipeline(
            _RectanglesOnNoise(VAL_IMAGES, HW, SEED + 8), HW, TRAIN_BATCH,
            cfg.max_boxes, mode="v2", shuffle=False, drop_remainder=False,
            **rows)
        calib_pipe = DetectionPipeline(
            train_set, HW, TRAIN_BATCH, cfg.max_boxes, mode="v2",
            shuffle=False)
        model = YOLOv2(dtype=torch.bfloat16, device=DEVICE, seed=SEED).eval()
        _calibrate_bn(model, _first(calib_pipe).image,
                      torch.Generator().manual_seed(SEED + 3))
        one = copy.deepcopy(model) if writer else None
        shard_model(model, dp)  # global rank 0's weights on both ranks
        res["sharded_layers"] = len(model_shards(model))

        # 1. The ranges, calibrated sharded (TF32 off inside the call).
        scales = calibrate_from_pipeline(model, calib_pipe)
        res["scales_crc"] = _crc(scales)
        if writer:
            ref = calibrate_from_pipeline(one, calib_pipe)
            res["calib_max_rel"] = float(((scales - ref).abs()
                                          / ref.abs()).max())

        # 2. One engine validation batch: its loss, and the codes at every
        # stop_after point and the head.
        val = _first(val_pipe)
        state = TrainState(model)
        res["val_loss"] = float(make_engine_eval_step(
            model, lambdas, scales, dp=dp)(state, val))
        res["engine_crcs"], res["engine_differs"] = [], []
        for stop in ENGINE_STOPS:
            got = te.yolov2_int8_forward(model, val.image, scales,
                                         stem="s2d", stop_after=stop)
            res["engine_crcs"].append(_crc(got))
            if writer and not torch.equal(got, te.yolov2_int8_forward(
                    one, val.image, scales, stem="s2d", stop_after=stop)):
                res["engine_differs"].append(stop)
        if writer:
            res["val_loss_one_card"] = float(make_engine_eval_step(
                one, lambdas, scales)(TrainState(one), val))
        # The f32 twin's head (no gradient) against one card's, with whole
        # convolutions and with the mesh's splits: relative l2.
        with torch.no_grad():
            twin = yolov2_qat_forward(model, val.image, scales)
            if writer:
                for key, split in (("twin_head_rel_l2_one_card", False),
                                   ("twin_head_rel_l2_split", True)):
                    with (_mesh_split_twin(dp.model_size) if split
                          else contextlib.nullcontext()):
                        ref = yolov2_qat_forward(one, val.image, scales)
                    res[key] = float((twin - ref).norm() / ref.norm())
        del twin

        # 3. One exact f32 step with device augmentation, its GEMMs
        # recorded; the one-card step from the same weights on rank 0.
        aug = AugmentConfig()
        batch = _first(train_pipe)
        before = {n: t.clone() for n, t in state.state_dict()["model"].items()}

        def exact_step(net, state, mesh):
            gemms = []
            step = make_qat_train_step(
                net, lambdas, scales, momentum=0.9,
                weight_decay=cfg.weight_decay, augment_cfg=aug, dp=mesh)
            gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
            with _swap_matmul(lambda real, a, b: gemms.append((a, b))
                              or real(a, b)):
                _, metrics = step(state, batch, QAT_LR, gen)
            return step, float(metrics["loss"]), gemms

        step, res["exact_loss"], gemms = exact_step(model, state, dp)
        after = state.state_dict()["model"]  # gathered

        def distance():
            """Relative l2 of the sharded update from the one-card one,
            over all parameters and at the worst leaf."""
            num = den = 0.0
            worst = (0.0, "")
            for n, p in one.named_parameters():
                want = p.detach() - before[n]
                d = float((after[n] - before[n] - want).norm())
                num += d * d
                den += float(want.norm()) ** 2
                worst = max(worst, (d / max(float(want.norm()), 1e-30), n))
            return (num / den) ** 0.5, list(worst)

        if writer:
            _, res["exact_loss_one_card"], one_gemms = exact_step(
                one, TrainState(one), None)
            (res["update_rel_l2_one_card"],
             res["update_worst_leaf_one_card"]) = distance()
            one.load_state_dict(before)
            with _mesh_split_twin(dp.model_size):
                _, res["exact_loss_split"], _ = exact_step(
                    one, TrainState(one), None)
            res["update_rel_l2"], res["update_worst_leaf"] = distance()
        del before, after

        # 5. Every GEMM of the step against the plain version; rank 0's
        # sliced ones against the columns of the one-card GEMM, and their
        # times beside the full width's (rank 1 waits at the barrier).
        res["gemms"] = []
        for i, (a, b) in enumerate(gemms):
            m, k = a.shape
            n = b.shape[1]
            got = matmul(a, b)
            g = {"m": m, "k": k, "n": n,
                 "route": route(m, n, k, a.dtype, a, b),
                 "plain_equal": torch.equal(got, matmul_plain(a, b))}
            if writer and n != one_gemms[i][1].shape[1]:
                a1, b1 = one_gemms[i]
                g["full_n"] = b1.shape[1]
                g["full_columns_equal"] = torch.equal(
                    got, matmul(a1, b1)[:, :n])
            res["gemms"].append(g)
        if writer:
            res["sliced_gemm_ms"] = []
            for (m, k, n) in sorted({(g["m"], g["k"], g["n"])
                                     for g in res["gemms"] if "full_n" in g}):
                i = next(j for j, g in enumerate(res["gemms"])
                         if (g["m"], g["k"], g["n"]) == (m, k, n))
                (a, b), (_, b1) = gemms[i], one_gemms[i]
                ms = graph_ms(lambda: matmul(a, b), 5)
                full_ms = graph_ms(lambda: matmul(a, b1), 5)
                nbytes, ops = _mm_bound(m, k, n, 1, 4)
                bms, by = bound_ms(nbytes, ops, INT8_OPS)
                res["sliced_gemm_ms"].append(dict(
                    m=m, k=k, n=n, ms=ms, tops=ops / ms / 1e9,
                    full_n=b1.shape[1], full_ms=full_ms, bound_ms=bms,
                    bound_by=by))
            del one_gemms
        del gemms
        dist.barrier()

        # 4. The main path: finetune_qat on the mesh, one epoch, counted.
        ckpt_dir = os.path.join(out_dir, "ckpt")
        matmul.launches = warp_affine.launches = 0
        matmul.launches_by_route = dict.fromkeys(matmul.launches_by_route, 0)
        t = time.perf_counter()
        state, hist = finetune_qat(
            model, state, train_pipe, val_pipe, scales, ckpt_dir, epochs=1,
            lr=QAT_LR, momentum=0.9, weight_decay=cfg.weight_decay,
            lambdas=lambdas, augment_cfg=aug, seed=SEED, mesh=dp)
        sync()
        res["finetune"] = dict(
            s=time.perf_counter() - t, steps=len(train_pipe),
            val_batches=len(val_pipe), hist=hist,
            launches={"int8_matmul": matmul.launches,
                      "warp_affine": warp_affine.launches},
            by_route=dict(matmul.launches_by_route))

        res["replicated_crc"] = _crc(torch.cat(
            [t.detach().reshape(-1).float() for t in
             (*model.parameters(), *model.buffers())
             if shard_of(t) is None]))

        # 6. The gathered checkpoint in a one-card model: its engine head
        # against the sharded one.
        head = te.yolov2_int8_forward(model, val.image, scales, stem="s2d")
        if writer:
            res["files"] = sorted(os.listdir(ckpt_dir))
            final = checkpoint.restore(
                os.path.join(ckpt_dir, "final_qat_model.ckpt"),
                TrainState(one))
            res["restored_step"] = final.step
            res["restored_head_equal"] = torch.equal(
                head, te.yolov2_int8_forward(final.model, val.image, scales,
                                             stem="s2d"))
            del final, one
        del head
        torch.cuda.empty_cache()

        # Timing: QAT_MP_STEPS steps after two warm-up steps, counted.
        gen = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
        for _ in range(2):
            step(state, batch, QAT_LR, gen)
        sync()
        torch.cuda.reset_peak_memory_stats()
        matmul.launches = warp_affine.launches = 0
        matmul.launches_by_route = dict.fromkeys(matmul.launches_by_route, 0)
        times = []
        for _ in range(QAT_MP_STEPS):
            t = time.perf_counter()
            step(state, batch, QAT_LR, gen)
            sync()
            times.append((time.perf_counter() - t) * 1e3)
        res["timed"] = dict(
            ms=times, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            launches={"int8_matmul": matmul.launches,
                      "warp_affine": warp_affine.launches},
            by_route=dict(matmul.launches_by_route))
        res["worker_s"] = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)


def phase_qat_mp(counters):
    """QAT under the mesh's model axis (``--qat --model-parallel 2``):
    YOLOv2-416 at batch 32, f32 parameters from seed 0 with BN calibrated
    and randomized as phase qat builds them, on a (data 1, model 2) mesh of
    two processes sharing the card over gloo, 11 convs sharded (stages 5-7
    and the neck).  Gates: the sharded calibration within rtol 1e-5 of the
    one-card ``calibrate`` (TF32 off) and equal on both ranks; one engine
    validation batch: the codes at every ``stop_after`` point and the head
    bitwise the one-card engine's, the loss equal; one exact f32 step with
    device augmentation: the loss bitwise the one-card step's and equal on
    both ranks, the gathered update within relative l2 1e-2 of the update
    of one card that convolves as the mesh splits (``_mesh_split_twin``;
    the distance from one card's whole convolutions is printed: the twin's
    f32 sums in another order flip fake-quant codes); the step's 20 GEMMs
    (11 on channel slices, N 256 and 512) bitwise equal to plain, all on
    the wgmma route, the sliced ones bitwise the one-card GEMM's columns;
    ``finetune_qat`` on the mesh for one epoch (the main path, counted: 20
    GEMMs a step and a validation batch, 1 warp a step, on each rank), the
    replicated parameters and buffers bitwise equal on both ranks after
    it; its gathered final checkpoint in a one-card model gives the
    sharded engine's head bitwise.  Then ms/step
    of three steps and peak memory on each rank (gloo stages every
    collective through the host: not model parallelism's speed), and each
    sliced GEMM shape's kernel time beside the full width's.  Returns the
    kernels' launches of both ranks (fine-tune and timed steps) and the
    GEMM's launches by route."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as out_dir:
        procs = [ctx.Process(target=_qat_mp_worker, args=(r, port, out_dir))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(600)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        ranks = []
        for r in range(2):
            path = os.path.join(out_dir, f"rank{r}.json")
            ranks.append(json.load(open(path)) if os.path.exists(path)
                         else {})
    print(json.dumps({"phase": "qat_mp", "gpu": gpu_line(), "ranks": ranks,
                      "note": "ms/step of two processes on one card over "
                      "gloo (host-staged collectives): not a measure of "
                      "model parallelism's speed"}))
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"qat_mp: worker exit codes "
                             f"{[p.exitcode for p in procs]}")
    return _qat_mp_gates(ranks, counters)


def _qat_mp_gates(ranks, counters):
    """Phase qat_mp's gates on the two ranks' results; returns their
    launches and the GEMM's launches by route."""
    r0, r1 = ranks
    if r0["sharded_layers"] != 11:
        raise AssertionError(f"qat_mp: {r0['sharded_layers']} sharded convs")
    if not r0["calib_max_rel"] <= 1e-5 or r0["scales_crc"] != r1["scales_crc"]:
        raise AssertionError(f"qat_mp: calibration {r0['calib_max_rel']}")
    if (r0["engine_differs"] or r0["engine_crcs"] != r1["engine_crcs"]
            or r0["val_loss"] != r0["val_loss_one_card"]
            or r1["val_loss"] != r0["val_loss"]):
        raise AssertionError(f"qat_mp: the engine differs from one card at "
                             f"{r0['engine_differs']}")
    if not (r0["exact_loss"] == r0["exact_loss_one_card"]
            == r0["exact_loss_split"] == r1["exact_loss"]):
        raise AssertionError(f"qat_mp: exact loss {r0['exact_loss']}, one "
                             f"card {r0['exact_loss_one_card']}, split "
                             f"{r0['exact_loss_split']}, rank 1 "
                             f"{r1['exact_loss']}")
    if not r0["update_rel_l2"] <= 1e-2:
        raise AssertionError(f"qat_mp: update rel l2 {r0['update_rel_l2']} "
                             "from one card with the mesh's conv splits")
    if r0["replicated_crc"] != r1["replicated_crc"]:
        raise AssertionError("qat_mp: the ranks' replicated parameters "
                             "differ after the fine-tune")
    for r in ranks:
        if len(r["gemms"]) != 20 or any(
                g["route"] != "wgmma" or not g["plain_equal"]
                for g in r["gemms"]):
            raise AssertionError(f"qat_mp: rank {r['rank']} GEMMs "
                                 f"{r['gemms']}")
    sliced = [g for g in r0["gemms"] if "full_n" in g]
    if (len(sliced) != 11 or {g["n"] for g in sliced} != {256, 512}
            or any(g["full_n"] != 2 * g["n"] or not g["full_columns_equal"]
                   for g in sliced)
            or [g["n"] for g in r1["gemms"]] != [g["n"] for g in r0["gemms"]]):
        raise AssertionError(f"qat_mp: sliced GEMMs {sliced}")
    launches = {k: 0 for k in counters}
    routes = {"wgmma": 0, "mma_sync": 0}
    for r in ranks:
        ft, timed = r["finetune"], r["timed"]
        calls = ft["steps"] + ft["val_batches"]
        _check_launches(f"qat_mp rank {r['rank']} fine-tune", ft["launches"],
                        {"int8_matmul": 20 * calls,
                         "warp_affine": ft["steps"]})
        _check_launches(f"qat_mp rank {r['rank']} fine-tune routes",
                        ft["by_route"], {"wgmma": 20 * calls, "mma_sync": 0})
        _check_launches(f"qat_mp rank {r['rank']} timed steps",
                        timed["launches"],
                        {"int8_matmul": 20 * QAT_MP_STEPS,
                         "warp_affine": QAT_MP_STEPS})
        if not all(math.isfinite(x) for x in ft["hist"]["train_loss_mean_list"]
                   + ft["hist"]["val_loss_list"]):
            raise AssertionError(f"qat_mp: losses {ft['hist']}")
        for part in (ft, timed):
            _add(launches, part["launches"])
            _add(routes, part["by_route"])
    if r0["files"] != sorted(["best_qat_model.ckpt", "final_qat_model.ckpt",
                              "int8_scales.npy", "metrics.jsonl"]):
        raise AssertionError(f"qat_mp: artifacts {r0['files']}")
    if not r0["restored_head_equal"]:
        raise AssertionError("qat_mp: the gathered checkpoint's one-card "
                             "head differs from the sharded engine's")
    print(f"qat_mp ({gpu_line()}): calibration max rel {r0['calib_max_rel']:.3e}"
          f"; engine codes and head bitwise at {len(ENGINE_STOPS)} points; "
          f"exact loss bitwise ({r0['exact_loss']}); update rel l2 "
          f"{r0['update_rel_l2']:.3e} from one card with the mesh's conv "
          f"splits, {r0['update_rel_l2_one_card']:.3e} from one card's "
          f"whole convs (the twin's head {r0['twin_head_rel_l2_split']:.3e} "
          f"and {r0['twin_head_rel_l2_one_card']:.3e} from them: summation "
          f"order, amplified); replicated state "
          f"equal on both ranks; 20 GEMMs a rank bitwise on wgmma; ms/"
          f"step rank 0 {statistics.median(r0['timed']['ms']):.1f}, rank 1 "
          f"{statistics.median(r1['timed']['ms']):.1f}; peak "
          f"{r0['timed']['peak_gb']:.2f} / {r1['timed']['peak_gb']:.2f} GB")
    return launches, routes


def phase_probe():
    """YOLOv3-416 bf16 at batch 256, eval mode, BN calibrated: each
    ``stop_after`` prefix (and the full forward) timed with CUDA events
    over a few calls; per-stage ms as differences of adjacent prefixes.
    One call runs under ``utils.profiler_trace`` into a temporary
    directory, which must then hold the trace."""
    from odc_tpu_torch.models import get_model
    from odc_tpu_torch.models.yolov3 import PROBES
    from odc_tpu_torch.utils import profiler_trace

    gen = torch.Generator().manual_seed(SEED + 30)
    x = torch.randint(0, 256, (V3_BATCH, *V3_HW, 3), generator=gen,
                      dtype=torch.uint8).to(DEVICE)
    model = get_model("YOLOv3", dtype=torch.bfloat16, device=DEVICE,
                      seed=SEED, image_size=V3_HW).eval()
    _calibrate_bn(model, x[:8], torch.Generator().manual_seed(SEED + 31))
    prefix = {}
    with torch.no_grad():
        for probe in (*PROBES, None):
            prefix[probe or "full"] = time_ms(
                lambda: model(x, stop_after=probe), PROBE_ITERS, warmup=1)
        names = list(prefix)
        stages = {names[0]: prefix[names[0]]}
        for a, b in zip(names, names[1:]):
            stages[b] = prefix[b] - prefix[a]
        with tempfile.TemporaryDirectory() as log_dir:
            with profiler_trace(log_dir):
                model(x)
                sync()
            traces = [(f, os.path.getsize(os.path.join(log_dir, f)))
                      for f in os.listdir(log_dir)]
    res = {"batch": V3_BATCH, "prefix_ms": prefix, "stage_ms": stages,
           "sum_of_stages_ms": sum(stages.values()),
           "negative_stages": [k for k, v in stages.items() if v < 0],
           "trace_files": traces}
    print(json.dumps({"phase": "probe", **res}))
    if not traces or not all(size > 0 for _, size in traces):
        raise AssertionError("probe: profiler_trace wrote no trace")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import odc_tpu_torch.ops.detect  # noqa: F401  (fails outside the repo)
    from odc_tpu_torch.ops.cuda.matmul_kernel import matmul
    from odc_tpu_torch.ops.cuda.nms_kernel import suppress
    from odc_tpu_torch.ops.cuda.superstem_kernel import superstem
    from odc_tpu_torch.ops.cuda.warp_kernel import warp_affine

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = gpu_line()
    print(gpu)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}")
    t0 = time.perf_counter()
    phase_build()
    nms = phase_nms()
    stem = phase_superstem()
    warp = phase_warp()
    epilogue = phase_bias_bn_leaky()
    torch.cuda.empty_cache()
    mish_epilogue = phase_yolov4()
    torch.cuda.empty_cache()
    phase_graph()
    launches, img_s, model, requests = phase_e2e()
    phase_matmul()
    counters = {"int8_matmul": matmul, "nms_suppress": suppress,
                "superstem": superstem}
    int8_launches, int8_img_s, mm, scales = phase_int8_e2e(
        model, requests, counters)
    del requests
    torch.cuda.empty_cache()
    native = phase_native(model, scales, counters)
    phase_eval(model, scales, counters)
    for wrapper in counters.values():
        wrapper.launches = 0
    loader_launches = phase_loader(model, counters)
    served, serve_res = phase_serve(model, scales, counters)
    del model, scales
    torch.cuda.empty_cache()
    every = {"int8_matmul": matmul, "nms_suppress": suppress,
             "superstem": superstem, "warp_affine": warp_affine}
    with tempfile.TemporaryDirectory() as map_root:
        trained = phase_int8_map("YOLOv2", map_root)
        train_launches, train_img_s = phase_train(every)
        torch.cuda.empty_cache()
        host_aug_launches = phase_host_augment(every)
        dp_launches = phase_dp(every)
        torch.cuda.empty_cache()
        remat_launches = phase_remat(every)
        mp_launches = phase_mp(every)
        torch.cuda.empty_cache()
        qat_mp_launches, qat_mp_routes = phase_qat_mp(every)
        torch.cuda.empty_cache()
        qat_launches, qat_routes, qat_img_s = phase_qat(every, trained)
        del trained
    torch.cuda.empty_cache()
    v1_launches, v1_img_s = phase_yolov1(every)
    torch.cuda.empty_cache()
    v1_train_launches, v1_train_img_s = phase_train(every, "YOLOv1", V1_HW)
    torch.cuda.empty_cache()
    v3_launches, v3_launches8, v3_img_s, v3_img_s8, v3_gemm = phase_yolov3(
        every)
    torch.cuda.empty_cache()
    phase_probe()
    torch.cuda.empty_cache()
    phase_int8_map("YOLOv3")
    v3_train_launches, v3_train_img_s = phase_train(every, "YOLOv3", V3_HW)
    print(f"launches by path: YOLOv2 serving {launches}, YOLOv2 training "
          f"{train_launches}, YOLOv2 QAT fine-tune {qat_launches}, YOLOv1 "
          f"serving {v1_launches}, YOLOv1 training {v1_train_launches}, "
          f"YOLOv3 serving bf16 {v3_launches}, int8_dynamic {v3_launches8}, "
          f"YOLOv3 training {v3_train_launches}, evaluate_batched with the "
          f"loader and PIL {loader_launches}, train epochs with host and "
          f"device augmentation {host_aug_launches}, data-parallel steps "
          f"{dp_launches}, steps with and without remat {remat_launches}, "
          f"model-axis steps (both ranks) {mp_launches}, QAT on the model "
          f"axis (both ranks) {qat_mp_launches}")
    print(f"launches of the served artifacts (phase serve): {served}")
    # Each kernel's launches are those of the main paths that run it (the
    # NMS: YOLOv2, YOLOv1 and both YOLOv3 serving paths, every served
    # artifact and phase loader's evaluator runs; the superstem: YOLOv2
    # bf16 serving, direct, from artifacts and in phase loader; the warp:
    # the three training paths, the QAT fine-tune, phase host_augment's
    # device epoch, phase dp's steps, phase remat's timed steps of both
    # variants, phase mp's timed steps on both ranks and phase qat_mp's
    # fine-tune and timed steps on both ranks;
    # the GEMM: the YOLOv2 int8 engine, the QAT fine-tune, phase qat_mp's
    # fine-tune and timed steps on both ranks (11 of each 20 on channel
    # slices), YOLOv3 int8_dynamic and their artifacts); the GEMM's times
    # are sums over the
    # 20 GEMMs of one YOLOv2 int8 call (the 32 of a YOLOv3 call are printed
    # above).
    kernels = [
        dict(name="nms_suppress", route="cuda",
             source="odc_tpu_torch/csrc/nms_suppress.cu",
             replaces="odc_tpu/ops/pallas/nms_kernel.py:100",
             launches=(launches["nms_suppress"] + v1_launches["nms_suppress"]
                       + v3_launches["nms_suppress"]
                       + v3_launches8["nms_suppress"]
                       + served["nms_suppress"]
                       + loader_launches["nms_suppress"]), **nms),
        dict(name="superstem", route="cuda",
             source="odc_tpu_torch/csrc/superstem.cu",
             replaces="odc_tpu/ops/pallas/superstem_kernel.py:270",
             launches=(launches["superstem"] + served["superstem"]
                       + loader_launches["superstem"]), **stem),
        dict(name="warp_affine", route="cuda",
             source="odc_tpu_torch/csrc/warp_affine.cu",
             replaces="odc_tpu/ops/pallas/warp_kernel.py:124",
             launches=(train_launches["warp_affine"]
                       + qat_launches["warp_affine"]
                       + v1_train_launches["warp_affine"]
                       + v3_train_launches["warp_affine"]
                       + host_aug_launches["warp_affine"]
                       + dp_launches["warp_affine"]
                       + remat_launches["warp_affine"]
                       + mp_launches["warp_affine"]
                       + qat_mp_launches["warp_affine"]), **warp),
        dict(name="int8_matmul", route="cuda",
             source="odc_tpu_torch/csrc/int8_matmul.cu",
             replaces="scripts/probe_int8_mxu.py:76",
             **{**mm, "launches_by_route": {
                 "wgmma": (mm["launches_by_route"]["wgmma"]
                           + qat_routes["wgmma"]
                           + qat_mp_routes["wgmma"]
                           + v3_launches8["int8_matmul"]
                           + served["wgmma"]),
                 "mma_sync": (mm["launches_by_route"]["mma_sync"]
                              + qat_routes["mma_sync"]
                              + qat_mp_routes["mma_sync"])}},
             launches=(int8_launches["int8_matmul"]
                       + qat_launches["int8_matmul"]
                       + qat_mp_launches["int8_matmul"]
                       + v3_launches8["int8_matmul"]
                       + served["int8_matmul"])),
        # The fused epilogue: its launches are those of phase e2e's calls
        # (one a block, 19 a YOLOv2 call); times and bounds are per call of
        # the bulk cells' shapes (phase bias_bn_leaky).
        dict(name="bias_bn_leaky", route="cuda",
             source="odc_tpu_torch/csrc/bias_bn_leaky.cu",
             replaces=None, launches=launches["bias_bn_leaky"],
             bitwise_unfused=True, **{f"{m}_{k}": v
                                      for m, d in epilogue.items()
                                      for k, v in d.items()}),
        # The Mish epilogue: its launches counted in phase yolov4's call
        # (one a Mish block); times and bounds a call of the YOLOv4 bulk
        # cell's shapes (phase yolov4).
        dict(name="bias_bn_mish", route="cuda",
             source="odc_tpu_torch/csrc/bias_bn_mish.cu",
             replaces=None, launches=mish_epilogue["launches_per_call"],
             bitwise_unfused=mish_epilogue["elements_differing"] == 0,
             **{f"YOLOv4_{k}": v for k, v in mish_epilogue.items()}),
    ]
    print(f"total {time.perf_counter() - t0:.1f} s; e2e {img_s:.1f} img/s; "
          f"int8 e2e {int8_img_s:.1f} img/s; train {train_img_s:.1f} img/s; "
          f"QAT {qat_img_s:.1f} img/s; "
          f"native (bucket calls, img/s) {native}; YOLOv1 e2e "
          f"{v1_img_s:.1f} img/s, train {v1_train_img_s:.1f} img/s; YOLOv3 "
          f"e2e bf16 {v3_img_s:.1f} img/s, int8_dynamic {v3_img_s8:.1f} "
          f"img/s (its 32 GEMMs {v3_gemm['ms']:.3f} ms a call, _int_mm "
          f"{v3_gemm['library_ms']:.3f}), train {v3_train_img_s:.1f} img/s; "
          f"served {json.dumps(serve_res)}")
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
