#!/usr/bin/env python3
"""Time the port's inference paths in this checkout and in another one, on
one card, in turns.

    python3 infer_ab.py --other DIR [--rounds 2]

DIR holds another checkout of the repository (for example a parent commit
unpacked with ``git archive``).  Each run is a fresh process started in one
of the two trees, whose ``odc_tpu_torch`` it imports; it builds that tree's
kernels, builds YOLOv2-416 (bf16 compute, f32 parameters from seed 0, BN
statistics set from one batch of 8) and times, on images already on the
card, the median of 20 calls (after 3 warm-up calls) of:

* ``make_infer_fn`` bf16 at batch 64 (the main path);
* ``make_infer_fn(int8_scales=...)``, s2d stem, calibrated on 32 images, at
  batch 64;
* ``make_native_infer_fn(int8_scales=...)`` at batch 16 in a 384x512 bucket
  (host-bound: about 1500 eager launches a call);
* ``make_native_infer_fn`` bf16 in the same bucket.

Each call ends in ``torch.cuda.synchronize()``; the host clock measures it.
The runs go this, other, other, this for each round.  Prints the card's
name and power limit, one line per run, each path's medians and spread per
tree, and one JSON object as its last line.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

PATHS = ("bf16_b64", "int8_b64", "native_int8_b16", "native_bf16_b16")

# Runs inside one tree (``python -c`` from its root puts it on sys.path).
_CHILD = r"""
import contextlib, json, statistics, time, torch
from unittest import mock
from odc_tpu_torch.models.layers import ConvBnLeaky, TorchBatchNorm
from odc_tpu_torch.models.yolov2 import YOLOv2
from odc_tpu_torch.ops.cuda import build
from odc_tpu_torch.ops.detect import make_infer_fn, make_native_infer_fn
from odc_tpu_torch.ops.int8_engine import calibrate

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
stale = [n for n in build.SOURCES if not build._fresh(n)]
if stale:
    build.build_all(stale)
dev = "cuda"
gen = torch.Generator().manual_seed(4)
def rand(*shape):
    return torch.randint(0, 256, shape, generator=gen,
                         dtype=torch.uint8).to(dev)
model = YOLOv2(dtype=torch.bfloat16, device=dev, seed=0).eval()
def set_stats(bn, args):
    x = args[0].float().reshape(-1, args[0].shape[-1])
    bn.running_mean.copy_(x.mean(0))
    bn.running_var.copy_(x.var(0))
hooks = [m.register_forward_pre_hook(set_stats) for m in model.modules()
         if isinstance(m, TorchBatchNorm)]
# A tree whose blocks fuse their epilogue skips the BN module on the card:
# the calibration pass runs the unfused one, so the hooks see every block.
unfused = (mock.patch.object(ConvBnLeaky, "_fuses_epilogue",
                             lambda self, x: False)
           if hasattr(ConvBnLeaky, "_fuses_epilogue")
           else contextlib.nullcontext())
with torch.no_grad(), unfused:
    model(rand(8, 416, 416, 3))
for h in hooks:
    h.remove()
scales = calibrate(model, rand(32, 416, 416, 3))
images, bucket = rand(64, 416, 416, 3), rand(16, 384, 512, 3)
valid_hw = torch.tensor([[384, 512]] * 16)
calls = {
    "bf16_b64": (make_infer_fn(model, 0.9, 0.5, 64), (images,)),
    "int8_b64": (make_infer_fn(model, 0.9, 0.5, 64, int8_scales=scales),
                 (images,)),
    "native_int8_b16": (make_native_infer_fn(model, 0.9, 0.5, 64,
                                             int8_scales=scales),
                        (bucket, valid_hw)),
    "native_bf16_b16": (make_native_infer_fn(model, 0.9, 0.5, 64),
                        (bucket, valid_hw)),
}
out = {}
for name, (fn, args) in calls.items():
    ms = []
    for i in range(23):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        if i >= 3:
            ms.append((time.perf_counter() - t) * 1e3)
    out[name] = statistics.median(ms)
print(json.dumps(out))
"""


def _run(tree: pathlib.Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=tree,
                          capture_output=True, text=True, timeout=1200)
    if proc.returncode != 0:
        raise RuntimeError(f"run in {tree} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", required=True, type=pathlib.Path)
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("infer_ab: no CUDA device", file=sys.stderr)
        return 1
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(gpu)
    trees = {"this": pathlib.Path(__file__).resolve().parent,
             "other": args.other.resolve()}
    runs = {"this": [], "other": []}
    for r in range(args.rounds):
        for tag in ("this", "other", "other", "this"):
            res = _run(trees[tag])
            runs[tag].append(res)
            print(f"round {r + 1} {tag}: " + ", ".join(
                f"{k} {v:.3f} ms" for k, v in res.items()), flush=True)
    summary = {}
    for tag, results in runs.items():
        summary[tag] = {}
        for path in PATHS:
            xs = sorted(x[path] for x in results)
            summary[tag][path] = {"median": statistics.median(xs),
                                  "min": xs[0], "max": xs[-1], "runs": xs}
    for path in PATHS:
        a, b = summary["this"][path], summary["other"][path]
        print(f"{path}: this {a['median']:.3f} ms ({a['min']:.3f}-"
              f"{a['max']:.3f}), other {b['median']:.3f} ms ({b['min']:.3f}-"
              f"{b['max']:.3f})")
    print(gpu)
    print(json.dumps({"gpu": gpu, **summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
