"""Fused Darknet-19 front ("superstem"): the CUDA kernel
(``csrc/superstem.cu``), its plain PyTorch version, the BN folding, and the
wrapper that picks between kernel and plain version by device.

Replaces ``odc_tpu/ops/pallas/superstem_kernel.py::superstem``:

    normalize -> conv1 3x3 (3->32) + BN + leaky -> maxpool 2x2
              -> conv2 3x3 (32->64) + BN + leaky -> maxpool 2x2

from uint8 NHWC images to the ``[B, H/4, W/4, 64]`` map that
``YOLOv2(stem_out=...)`` takes.  BN is folded into the weights once
(:func:`fold_weights`); taps and weights are rounded to the weight dtype and
accumulated in f32.  Unlike the TPU kernel, any H, W >= 4 works (floor
pooling, as the unfused stem).

Bound on the card: arithmetic — about 1.9 GFLOP against 1.9 MB of HBM
traffic per 416x416 image.  The bf16 kernel (the main path) runs both
convolutions on the tensor cores as implicit GEMMs from shared memory
(``mma.sync`` m16n8k16, f32 sums; one CTA per 8 x 16 tile of outputs), pools
in registers and keeps the pooled conv1 map in shared memory as bf16, so only
the uint8 input and the final map cross HBM.  The f32 kernel, off the main
path, is a direct convolution on the CUDA cores: the tensor cores have no
full-f32 product.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from odc_tpu_torch.core.image import imagenet_normalize
from odc_tpu_torch.ops.cuda import build

_LAUNCHERS = {torch.bfloat16: "superstem_bf16", torch.float32: "superstem_f32"}


def fold_weights(
    k1, b1, s1, be1, m1, v1, k2, b2, s2, be2, m2, v2,
    eps: float = 1e-5, dtype: torch.dtype = torch.bfloat16,
):
    """Fold inference BN into both convs; the bias rides as one extra tap.

    ``k1`` [32, 3, 3, 3] and ``k2`` [64, 32, 3, 3] are PyTorch conv weights
    [out, in, kh, kw]; the rest are the conv biases and the BN
    scale/bias/mean/var.  Returns ``(w1 [32, 28], w2 [64, 289])`` in
    ``dtype`` with tap order ``(ky*3 + kx)*Cin + c``, bias last — the JAX
    package's layout, with its f32 arithmetic op for op."""
    sc1 = s1 / torch.sqrt(v1 + eps)
    sc2 = s2 / torch.sqrt(v2 + eps)
    bias1 = (b1 - m1) * sc1 + be1
    bias2 = (b2 - m2) * sc2 + be2
    t1 = (k1 * sc1[:, None, None, None]).permute(0, 2, 3, 1).reshape(32, 27)
    t2 = (k2 * sc2[:, None, None, None]).permute(0, 2, 3, 1).reshape(64, 288)
    w1 = torch.cat([t1, bias1[:, None]], dim=1).to(dtype).contiguous()
    w2 = torch.cat([t2, bias2[:, None]], dim=1).to(dtype).contiguous()
    return w1, w2


def _conv_weight(w: torch.Tensor, cin: int) -> torch.Tensor:
    """[out, 9*cin + 1] folded rows -> f32 [out, cin, 3, 3] conv weight."""
    out = w.shape[0]
    return w[:, :-1].float().reshape(out, 3, 3, cin).permute(0, 3, 1, 2)


def superstem_plain(
    x_u8: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: [B, H, W, 3] uint8 ->
    [B, H/2/2, W/2/2, 64] in the weights' dtype.  Taps are rounded to the
    weight dtype and convolved in f32, so it accumulates in f32 like the
    kernel (a bf16 ``F.conv2d`` would round every conv output first)."""
    wdt = w1.dtype
    h = imagenet_normalize(x_u8, torch.float32).permute(0, 3, 1, 2)
    h = F.conv2d(h.to(wdt).float(), _conv_weight(w1, 3), w1[:, -1].float(),
                 padding=1)
    h = F.leaky_relu(F.max_pool2d(h, 2), 0.1)
    h = F.conv2d(h.to(wdt).float(), _conv_weight(w2, 32), w2[:, -1].float(),
                 padding=1)
    h = F.leaky_relu(F.max_pool2d(h, 2), 0.1)
    return h.permute(0, 2, 3, 1).to(wdt).contiguous()


def _launch(x_u8: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor):
    b, h, w, _ = x_u8.shape
    out = torch.empty(
        (b, h // 2 // 2, w // 2 // 2, 64), dtype=w1.dtype, device=x_u8.device
    )
    if b == 0:
        return out
    lib = build.load("superstem")
    with torch.cuda.device(x_u8.device):
        err = getattr(lib, _LAUNCHERS[w1.dtype])(
            x_u8.data_ptr(), w1.data_ptr(), w2.data_ptr(), out.data_ptr(),
            b, h, w, torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, "superstem")
    superstem.launches += 1
    return out


def superstem(
    x_u8: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor
) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> [B, H/4, W/4, 64] (floor pooling) in the
    weights' dtype, with weights from :func:`fold_weights`.

    Calls the operator ``odc_tpu_torch::superstem`` (``ops.py``): a CPU
    tensor runs :func:`superstem_plain`; a CUDA tensor launches the kernel
    or raises."""
    if x_u8.dim() != 4 or x_u8.shape[-1] != 3 or x_u8.dtype != torch.uint8:
        raise ValueError("x must be a [B, H, W, 3] uint8 tensor")
    if x_u8.shape[1] < 4 or x_u8.shape[2] < 4:
        raise ValueError(f"superstem needs H, W >= 4, got {tuple(x_u8.shape)}")
    if tuple(w1.shape) != (32, 28) or tuple(w2.shape) != (64, 289):
        raise ValueError("w1 must be [32, 28] and w2 [64, 289]")
    if w1.dtype != w2.dtype or w1.dtype not in _LAUNCHERS:
        raise TypeError(f"weights must both be bf16 or f32, got {w1.dtype}")
    if not (w1.device == w2.device == x_u8.device):
        raise ValueError("x, w1 and w2 must be on the same device")
    if x_u8.device.type == "cuda":
        if not (x_u8.is_contiguous() and w1.is_contiguous()
                and w2.is_contiguous()):
            raise ValueError("x, w1 and w2 must be contiguous")
    elif x_u8.device.type != "cpu":
        raise ValueError(f"unsupported device {x_u8.device}")
    return torch.ops.odc_tpu_torch.superstem(x_u8, w1, w2)


build.counted(superstem)
