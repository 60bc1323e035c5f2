"""The yardstick's arithmetic: published peaks, operation counts from
shapes, and the least time each kernel's function needs.

Every count is of the FUNCTION, from its shapes, whatever implements it:
a later kernel that computes the same function keeps the same count.  The
kernel bounds are frozen copies of the port's on-card smoke script's
(superstem, NMS); a later kernel adds its count in a file of its own.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at its full
700 W power limit).
"""

from __future__ import annotations

import subprocess
from typing import Dict, Iterable, Optional

HBM_BPS = 3.35e12      # bytes/s
BF16_FLOPS = 989e12    # tensor cores, dense
INT8_OPS = 1979e12     # tensor cores, dense
F32_FLOPS = 67e12      # CUDA cores


def bound_s(nbytes: float, flops: float, rate: float) -> float:
    """Least time: the larger of bytes over HBM bandwidth and operations
    over the peak rate."""
    return max(nbytes / HBM_BPS, flops / rate)


def conv_flops_per_image(cfg: dict) -> float:
    """Forward FLOPs of one image: 2 x multiply-adds of every convolution
    at its output resolution (BatchNorm, activations, pools, decode and NMS
    are not counted), from the configuration's layer list."""
    h, w = cfg["image_size"]
    nc = cfg["num_cls"]
    total = 0.0

    def conv(oh, ow, cin, cout, k):
        nonlocal total
        total += 2.0 * oh * ow * cin * cout * k * k

    if cfg["model"] == "YOLOv2":
        cin, s = 3, 1
        for i, stage in enumerate(cfg["darknet19_stages"]):
            if 1 <= i <= 5:
                s *= 2
            for f, k in stage:
                conv(h // s, w // s, cin, f, k)
                cin = f
        c5 = cfg["darknet19_stages"][4][-1][0]
        conv(h // 32, w // 32, 4 * c5 + cin, cfg["neck_features"], 3)
        conv(h // 32, w // 32, cfg["neck_features"],
             len(cfg["anchors"]) * (5 + nc), 1)
        return total
    if cfg["model"] != "YOLOv3":
        raise KeyError(f"no count for model {cfg['model']!r}")
    conv(h, w, 3, 32, 3)
    cin, s = 32, 1
    for f, repeat in cfg["darknet53_blocks"]:
        s *= 2
        oh, ow = -(-h // s), -(-w // s)
        conv(oh, ow, cin, f, 3)
        for _ in range(repeat):
            conv(oh, ow, f, f // 2, 1)
            conv(oh, ow, f // 2, f, 3)
        cin = f
    a = 3 * (5 + nc)
    for stride, cin, f, first, up in ((32, 1024, 512, True, None),
                                       (16, 256, 256, False, (256, 512)),
                                       (8, 128, 128, False, (128, 256))):
        oh, ow = h // stride, w // stride
        if up is not None:
            # The reduce and the merge's 1x1 over the reduced map at the
            # coarser scale (it commutes with the nearest upsample), the
            # merge's 1x1 over the tap at this one.
            conv(oh // 2, ow // 2, 2 * up[0], up[0], 1)
            conv(oh // 2, ow // 2, up[0], f, 1)
            conv(oh, ow, up[1], f, 1)
            c = f
        else:
            c = cin
        plan = [(1, f), (3, 2 * f), (1, f), (3, 2 * f), (1, f)]
        for k, co in (plan if first else plan[1:]):
            conv(oh, ow, c, co, k)
            c = co
        conv(oh, ow, f, 2 * f, 3)
        conv(oh, ow, 2 * f, a, 1)
    return total


def superstem_bound_s(batch: int, h: int, w: int) -> float:
    """Darknet-19 stages 1-2 as one function: uint8 images in, the pooled
    bf16 [B, H/4, W/4, 64] map out, the two convolutions' FLOPs (3x3 3->32
    at full size, 3x3 32->64 at half), at the bf16 rate."""
    flops = batch * (h * w * 32 * 27 * 2 + (h // 2) * (w // 2) * 64 * 288 * 2)
    nbytes = batch * (h * w * 3 + (h // 4) * (w // 4) * 64 * 2) + 2 * (32 * 28 + 64 * 289)
    return bound_s(nbytes, flops, BF16_FLOPS)


def nms_bound_s(valid_per_image: Iterable[int], k: int) -> float:
    """Greedy suppression of score-sorted candidates: each image's n valid
    candidates need n(n-1)/2 IoU tests of 14 operations and 3 per box (its
    area), at the f32 rate; bytes: the valid boxes read once (16 B each),
    the [B, K] valid flags read and keep flags written."""
    flops = nbytes = 0.0
    for n in valid_per_image:
        n = min(int(n), k)
        flops += n * (n - 1) / 2 * 14 + 3 * n
        nbytes += 16 * n + 2 * k
    return bound_s(nbytes, flops, F32_FLOPS)


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    None where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def summary(cfg: dict) -> Dict[str, float]:
    """The numbers a configuration file records: parameters and forward
    GFLOP an image."""
    from benchmark.reference import nets

    return {"params": nets.param_count(cfg),
            "forward_gflop_per_image": conv_flops_per_image(cfg) / 1e9}
