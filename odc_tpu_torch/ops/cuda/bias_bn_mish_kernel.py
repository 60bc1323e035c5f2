"""The Mish conv blocks' inference epilogue (YOLOv4's CBM): conv bias +
BatchNorm (running statistics) + Mish + the cast to bf16 as one CUDA kernel
(``csrc/bias_bn_mish.cu``), its plain PyTorch version, and the wrapper that
picks between them by device.

The twin of ``bias_bn_leaky_kernel.py`` with ``F.mish`` in place of leaky:
unfused, ATen runs the bf16 bias add, four f32 BN passes, Mish and the cast
back as separate passes over the whole map (about 60-70 bytes of HBM
traffic an element); the kernel reads the bf16 conv output once and writes
the bf16 result once, 4 bytes an element.

The result is bitwise that of the unfused passes: the bias and BN round op
by op as ATen's separate kernels do, and the kernel's Mish, a cheaper
formula that falls back to ATen's (``y * tanhf(log1pf(expf(y)))`` in f32,
the same CUDA math library functions compiled with FMA contraction on)
near bf16 rounding midpoints, equals ``F.mish`` after the cast to bf16 for
every one of the 2^32 f32 inputs (:func:`mish_table`, checked on the card by
``chip_smoke.py`` phase ``yolov4`` and ``tests/test_torch_yolov4.py``).
:func:`bias_bn_mish_plain` is the unfused op sequence.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from odc_tpu_torch.ops.cuda import build
from odc_tpu_torch.ops.cuda.bias_bn_leaky_kernel import check_epilogue_args


def bias_bn_mish_plain(
    x: torch.Tensor, conv_bias: torch.Tensor, mean: torch.Tensor,
    var: torch.Tensor, weight: torch.Tensor, shift: torch.Tensor,
    eps: float,
) -> torch.Tensor:
    """``x`` [..., C] bf16 (a conv output without its bias) -> [..., C]
    bf16: the bias add in bf16, then ``TorchBatchNorm``'s eval forward,
    ``F.mish`` and the cast back, op for op as
    ``ConvBnLeaky(activation="mish").forward`` runs them on the card."""
    t = x + conv_bias.to(x.dtype)
    y = (t.float() - mean) * torch.rsqrt(var + eps)
    y = y * weight + shift
    return F.mish(y).to(x.dtype)


def _launch(x, conv_bias, mean, var, weight, shift, eps):
    out = torch.empty_like(x)
    c = x.shape[-1]
    m = x.numel() // c
    if m == 0:
        return out
    lib = build.load("bias_bn_mish")
    with torch.cuda.device(x.device):
        err = lib.bias_bn_mish_bf16(
            x.data_ptr(), out.data_ptr(), conv_bias.data_ptr(),
            mean.data_ptr(), var.data_ptr(), weight.data_ptr(),
            shift.data_ptr(), m, c, float(eps),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, "bias_bn_mish")
    bias_bn_mish.launches += 1
    return out


def bias_bn_mish(
    x: torch.Tensor, conv_bias: torch.Tensor, mean: torch.Tensor,
    var: torch.Tensor, weight: torch.Tensor, shift: torch.Tensor,
    eps: float,
) -> torch.Tensor:
    """The epilogue of :func:`bias_bn_mish_plain` on a contiguous bf16
    ``x`` [..., C] with C a multiple of 8 and five contiguous f32 [C]
    vectors on its device.

    Calls the operator ``odc_tpu_torch::bias_bn_mish`` (``ops.py``): a CPU
    tensor runs the plain version; a CUDA tensor launches the kernel or
    raises.  ``x`` must start on a 16-byte boundary (the operator checks
    on every device; the leaky kernel's contract, though this kernel moves
    4 channels as one 8-byte load)."""
    check_epilogue_args(x, conv_bias, mean, var, weight, shift)
    return torch.ops.odc_tpu_torch.bias_bn_mish(
        x, conv_bias, mean, var, weight, shift, float(eps))


build.counted(bias_bn_mish)


def mish_mismatches(device="cuda", chunk: int = 2**28):
    """``(inputs, NaN inputs)``: how many of all 2^32 f32 bit patterns the
    kernel's Mish, cast to bf16, maps elsewhere than ``F.mish(y)`` cast to
    bf16 does on ``device`` (a card)."""
    bad = nan = 0
    for lo in range(-2**31, 2**31, chunk):
        y = torch.arange(lo, lo + chunk, dtype=torch.int32,
                         device=device).view(torch.float32)
        want = F.mish(y).to(torch.bfloat16).view(torch.int16)
        diff = mish_table(lo, chunk, device) != want
        bad += int(diff.sum())
        nan += int((diff & torch.isnan(y)).sum())
    return bad, nan


def mish_table(start: int, count: int, device="cuda") -> torch.Tensor:
    """The kernel's Mish, cast to bf16, of the f32 inputs whose bit patterns
    are ``start`` .. ``start + count - 1`` (mod 2^32), as an int16 [count]
    tensor of bf16 bit patterns on ``device`` (a card)."""
    out = torch.empty(count, dtype=torch.int16, device=device)
    lib = build.load("bias_bn_mish")
    with torch.cuda.device(out.device):
        err = lib.bias_bn_mish_table(
            start % 2**32, count, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "bias_bn_mish_table")
    return out
