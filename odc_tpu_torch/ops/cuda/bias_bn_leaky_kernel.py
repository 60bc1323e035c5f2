"""The conv blocks' inference epilogue: conv bias + BatchNorm (running
statistics) + leaky + the cast to bf16 as one CUDA kernel
(``csrc/bias_bn_leaky.cu``), its plain PyTorch version, and the wrapper that
picks between them by device.

Replaces no TPU kernel: XLA fused these elementwise ops into the TPU
convolution's epilogue.  On the card ``models/layers.py::ConvBnLeaky`` ran
them as separate ATen passes, each over the whole map (about 60-70 bytes of
HBM traffic an element); the kernel reads the bf16 conv output once and
writes the bf16 result once, 4 bytes an element, which bound it.

The result is bitwise that of the unfused passes: every step rounds as
ATen's separate kernels do (the bias rounded to bf16 and added in bf16, BN
in f32 op by op with no contraction, leaky in f32, then round to nearest
even).  :func:`bias_bn_leaky_plain` is that op sequence.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from odc_tpu_torch.ops.cuda import build


def bias_bn_leaky_plain(
    x: torch.Tensor, conv_bias: torch.Tensor, mean: torch.Tensor,
    var: torch.Tensor, weight: torch.Tensor, shift: torch.Tensor,
    eps: float, negative_slope: float,
) -> torch.Tensor:
    """``x`` [..., C] bf16 (a conv output without its bias) -> [..., C]
    bf16: the bias add in bf16, then ``TorchBatchNorm``'s eval forward,
    leaky and the cast back, op for op as ``ConvBnLeaky.forward`` runs them
    on the card."""
    t = x + conv_bias.to(x.dtype)
    y = (t.float() - mean) * torch.rsqrt(var + eps)
    y = y * weight + shift
    return F.leaky_relu(y, negative_slope).to(x.dtype)


def check_epilogue_args(x, conv_bias, mean, var, weight, shift) -> None:
    """Raise unless ``x`` is a contiguous bf16 [..., C] tensor on the CPU or
    a card with C a positive multiple of 8, and the five vectors contiguous
    f32 [C] tensors on its device (what the epilogue kernels take)."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bfloat16, got {x.dtype}")
    if x.dim() < 1 or x.shape[-1] % 8 != 0 or x.shape[-1] == 0:
        raise ValueError(f"x needs a last dim that is a positive multiple "
                         f"of 8, got {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    c = x.shape[-1]
    for name, t in (("conv_bias", conv_bias), ("mean", mean), ("var", var),
                    ("weight", weight), ("shift", shift)):
        if t.dtype != torch.float32 or tuple(t.shape) != (c,):
            raise ValueError(f"{name} must be a float32 [{c}] tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")


def _launch(x, conv_bias, mean, var, weight, shift, eps, negative_slope):
    out = torch.empty_like(x)
    c = x.shape[-1]
    m = x.numel() // c
    if m == 0:
        return out
    lib = build.load("bias_bn_leaky")
    with torch.cuda.device(x.device):
        err = lib.bias_bn_leaky_bf16(
            x.data_ptr(), out.data_ptr(), conv_bias.data_ptr(),
            mean.data_ptr(), var.data_ptr(), weight.data_ptr(),
            shift.data_ptr(), m, c, float(eps), float(negative_slope),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, "bias_bn_leaky")
    bias_bn_leaky.launches += 1
    return out


def bias_bn_leaky(
    x: torch.Tensor, conv_bias: torch.Tensor, mean: torch.Tensor,
    var: torch.Tensor, weight: torch.Tensor, shift: torch.Tensor,
    eps: float, negative_slope: float,
) -> torch.Tensor:
    """The epilogue of :func:`bias_bn_leaky_plain` on a contiguous bf16
    ``x`` [..., C] with C a multiple of 8 and five contiguous f32 [C]
    vectors on its device.

    Calls the operator ``odc_tpu_torch::bias_bn_leaky`` (``ops.py``): a CPU
    tensor runs the plain version; a CUDA tensor launches the kernel or
    raises.  ``x`` must start on a 16-byte boundary (the operator checks,
    on every device): the kernel moves 8 channels as one 16-byte load."""
    check_epilogue_args(x, conv_bias, mean, var, weight, shift)
    return torch.ops.odc_tpu_torch.bias_bn_leaky(
        x, conv_bias, mean, var, weight, shift, float(eps),
        float(negative_slope))


build.counted(bias_bn_leaky)
