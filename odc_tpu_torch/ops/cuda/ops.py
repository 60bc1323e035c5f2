"""The port's kernels as opaque PyTorch operators.

``torch.library.custom_op`` registers ``odc_tpu_torch::nms_suppress``,
``odc_tpu_torch::superstem``, ``odc_tpu_torch::int8_matmul``,
``odc_tpu_torch::bias_bn_leaky`` and ``odc_tpu_torch::bias_bn_mish``.  The
wrappers (``nms_kernel.suppress``, ``superstem_kernel.superstem``,
``matmul_kernel.matmul``, ``bias_bn_leaky_kernel.bias_bn_leaky``,
``bias_bn_mish_kernel.bias_bn_mish``) check shapes and types and call
these operators, so eager code and a program captured by ``torch.export``
(the serving artifact, ``serve/engine.py``) run one and the same operator.
Tracing sees only the fake implementation, which gives the output's shape
and type (symbolic in the batch); everything that reads a data pointer or
launches a kernel is in the real implementation below: the alignment
checks, the GEMM's route, the ``ctypes`` launch and the launch counters.

The real implementation runs the plain PyTorch version for CPU tensors and
the kernel for CUDA tensors; it never falls back from one to the other.

Importing this module (``odc_tpu_torch.ops.cuda`` does) registers the
operators; it imports nothing of ``odc_tpu_torch.models``, so a host can
load an artifact without the model code.
"""

from __future__ import annotations

from typing import Optional

import torch

from odc_tpu_torch.ops.cuda import (
    bias_bn_leaky_kernel, bias_bn_mish_kernel, matmul_kernel, nms_kernel,
    superstem_kernel,
)


@torch.library.custom_op("odc_tpu_torch::nms_suppress", mutates_args=())
def nms_suppress(boxes: torch.Tensor, valid: torch.Tensor,
                 iou_thre: torch.Tensor) -> torch.Tensor:
    """Keep mask [B, K] of score-sorted ``boxes`` [B, K, 4]; ``iou_thre`` is
    a 0-d float32 tensor, read on the host (keep it on the CPU: one on the
    card would cost a device-to-host copy a call)."""
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must start on a 16-byte boundary")
    if boxes.device.type == "cpu":
        return nms_kernel.suppress_plain(boxes, valid, iou_thre)
    return nms_kernel._launch(boxes, valid, float(iou_thre))


@nms_suppress.register_fake
def _(boxes, valid, iou_thre):
    return torch.empty_like(valid)


@torch.library.custom_op("odc_tpu_torch::superstem", mutates_args=())
def superstem(x_u8: torch.Tensor, w1: torch.Tensor,
              w2: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> [B, H/4, W/4, 64] in the weights' dtype."""
    if x_u8.device.type == "cpu":
        return superstem_kernel.superstem_plain(x_u8, w1, w2)
    return superstem_kernel._launch(x_u8, w1, w2)


@superstem.register_fake
def _(x_u8, w1, w2):
    b, h, w, _ = x_u8.shape
    return x_u8.new_empty((b, h // 2 // 2, w // 2 // 2, 64), dtype=w1.dtype)


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


@torch.library.custom_op("odc_tpu_torch::int8_matmul", mutates_args=())
def int8_matmul(a: torch.Tensor, b: torch.Tensor,
                path: Optional[str] = None) -> torch.Tensor:
    """``a [M, K] @ b [K, N]`` (``b`` the transpose of a contiguous
    ``[N, K]`` tensor): int8 -> int32, bf16 -> f32.

    With ``path=None`` on the card, an int8 operand whose base is off a
    16-byte boundary (a view a captured program may hand over) is copied to
    a fresh buffer first, so the shape alone picks the route: such a
    product runs on ``wgmma`` as it does in eager code."""
    m, k = a.shape
    n = b.shape[1]
    if (path is None and a.device.type == "cuda" and a.dtype == torch.int8
            and k % 16 == 0):
        if not _aligned(a):
            a = a.clone()
        if not _aligned(b):
            b = b.t().clone().t()
    picked = matmul_kernel.route(m, n, k, a.dtype, a, b)
    if path not in (None, "mma_sync", picked):
        raise ValueError(f"route {path!r} cannot take this input (route() "
                         f"picks {picked!r})")
    if a.device.type == "cpu":
        return matmul_kernel.matmul_plain(a, b)
    return matmul_kernel._launch(a, b, path or picked)


@int8_matmul.register_fake
def _(a, b, path=None):
    return a.new_empty((a.shape[0], b.shape[1]),
                       dtype=matmul_kernel.OUT_DTYPE[a.dtype])


@torch.library.custom_op("odc_tpu_torch::bias_bn_leaky", mutates_args=())
def bias_bn_leaky(x: torch.Tensor, conv_bias: torch.Tensor,
                  mean: torch.Tensor, var: torch.Tensor, weight: torch.Tensor,
                  shift: torch.Tensor, eps: float,
                  negative_slope: float) -> torch.Tensor:
    """bf16 [..., C] conv output without bias -> bf16 [..., C] after the
    bias, BN with running statistics, leaky and the cast."""
    if not _aligned(x):
        raise ValueError("x must start on a 16-byte boundary")
    if x.device.type == "cpu":
        return bias_bn_leaky_kernel.bias_bn_leaky_plain(
            x, conv_bias, mean, var, weight, shift, eps, negative_slope)
    return bias_bn_leaky_kernel._launch(
        x, conv_bias, mean, var, weight, shift, eps, negative_slope)


@bias_bn_leaky.register_fake
def _(x, conv_bias, mean, var, weight, shift, eps, negative_slope):
    return torch.empty_like(x)


@torch.library.custom_op("odc_tpu_torch::bias_bn_mish", mutates_args=())
def bias_bn_mish(x: torch.Tensor, conv_bias: torch.Tensor,
                 mean: torch.Tensor, var: torch.Tensor, weight: torch.Tensor,
                 shift: torch.Tensor, eps: float) -> torch.Tensor:
    """bf16 [..., C] conv output without bias -> bf16 [..., C] after the
    bias, BN with running statistics, Mish and the cast."""
    if not _aligned(x):
        raise ValueError("x must start on a 16-byte boundary")
    if x.device.type == "cpu":
        return bias_bn_mish_kernel.bias_bn_mish_plain(
            x, conv_bias, mean, var, weight, shift, eps)
    return bias_bn_mish_kernel._launch(
        x, conv_bias, mean, var, weight, shift, eps)


@bias_bn_mish.register_fake
def _(x, conv_bias, mean, var, weight, shift, eps):
    return torch.empty_like(x)
