"""int8 quantization and the int8 convolution of the PTQ paths.

Port of ``odc_tpu/ops/quantize.py`` (dynamic per-tensor activations,
per-output-channel weights, the quantized neck ``int8_conv_bn_leaky``) plus
the int8 convolution the JAX package leaves to XLA
(``lax.conv_general_dilated(..., preferred_element_type=int32)``).  PyTorch
has no int8 convolution on CUDA, so here it is an im2col in PyTorch followed
by the hand-written GEMM (``ops/cuda/matmul_kernel.py::matmul``), whose
int32 sums are exact: the accumulator is bitwise XLA's.

Weights keep the JAX package's HWIO layout ``[kh, kw, I, O]`` at these
functions (:func:`hwio` converts a PyTorch ``[O, I, kh, kw]`` weight), and
activations are NHWC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from odc_tpu_torch.ops.cuda import matmul_kernel

# The GEMM reads K in 32-byte slices; a contraction that is not a multiple
# of this (the 3-channel stem conv, K = 27) is zero-padded up to it in both
# operands, so every row load stays aligned.
K_ALIGN = 32


def hwio(weight: torch.Tensor) -> torch.Tensor:
    """PyTorch conv weight ``[O, I, kh, kw]`` -> HWIO ``[kh, kw, I, O]``."""
    return weight.permute(2, 3, 1, 0)


def quantize_dynamic(x: torch.Tensor):
    """Per-tensor symmetric int8: returns (q int8, scale f32 scalar)."""
    xf = x.float()
    amax = xf.abs().amax()
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_weights_per_channel(kernel: torch.Tensor):
    """[kh, kw, I, O] -> (q int8, scale f32 [O]) symmetric per-out-channel."""
    k = kernel.float()
    amax = k.abs().amax(dim=(0, 1, 2))
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(k / scale), -127, 127).to(torch.int8)
    return q, scale


def _im2col(x: torch.Tensor, k: int, stride: int, kp: int, pads=None):
    """NHWC ``x`` -> (``[B*Ho*Wo, kp]`` patches, Ho, Wo).  K is ordered
    (ky, kx, c) like an HWIO weight; the border is padded with code 0 (not
    the zero point: the engine corrects the border itself), by ``pads``
    ``((top, bottom), (left, right))`` when given, else ``k // 2``
    rows/cols a side at stride 1 and ``(k - 2) // 2`` at stride 2; zero
    columns fill ``k*k*C`` up to ``kp``."""
    b, h, w, c = x.shape
    if pads is None:
        p = k // 2 if stride == 1 else (k - stride) // 2
        pads = ((p, p), (p, p))
    (pt, pb), (pl, pr) = pads
    ho = (h + pt + pb - k) // stride + 1
    wo = (w + pl + pr - k) // stride + 1
    if k == 1 and kp == c and stride == 1 and not any(pads[0] + pads[1]):
        return x.reshape(b * h * w, c), ho, wo
    xp = F.pad(x, (0, 0, pl, pr, pt, pb))
    cols = [
        xp[:, dy : dy + stride * (ho - 1) + 1 : stride,
           dx : dx + stride * (wo - 1) + 1 : stride]
        for dy in range(k)
        for dx in range(k)
    ]
    if kp > k * k * c:
        cols.append(x.new_zeros((b, ho, wo, kp - k * k * c)))
    return torch.cat(cols, dim=-1).reshape(b * ho * wo, kp), ho, wo


def conv_i8(xq: torch.Tensor, wq: torch.Tensor, stride: int = 1,
            pads=None) -> torch.Tensor:
    """int8 NHWC ``xq`` [B, H, W, I] (*) int8 HWIO ``wq`` [k, k, I, O] ->
    exact int32 NHWC accumulator, zero padding.

    Takes the convolutions of the int8 paths: SAME stride 1 with k = 1 or 3,
    the lifted 4x4/stride-2 conv with one row/col of padding on each side
    (``int8_engine._s2d_stem_kernel``), and the 3x3/stride-2 conv with
    explicit per-side ``pads`` ``((top, bottom), (left, right))`` (XLA's
    SAME is ``(0, 1)`` on an even size, ``layers.same_padding``; ``VALID``
    is zeros).  Code 0 is the padding value: exact for the symmetric
    dynamic quantization, whose zero point is 0.  A 1x1 conv needs no
    im2col."""
    k = wq.shape[0]
    if (k, stride) not in ((1, 1), (3, 1), (4, 2), (3, 2)) or wq.shape[1] != k:
        raise ValueError(
            f"conv_i8 takes 1x1 and 3x3 stride 1, 4x4 stride 2 or 3x3 "
            f"stride 2, got {tuple(wq.shape[:2])} stride {stride}")
    if (k, stride) == (3, 2) and pads is None:
        raise ValueError("a 3x3 stride-2 conv needs explicit pads")
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"need int8 codes, got {xq.dtype} and {wq.dtype}")
    if xq.dim() != 4 or xq.shape[-1] != wq.shape[2]:
        raise ValueError(
            f"need NHWC input with {wq.shape[2]} channels, got "
            f"{tuple(xq.shape)}")
    cout = wq.shape[3]
    kk = k * k * wq.shape[2]
    kp = -(-kk // K_ALIGN) * K_ALIGN
    bt = wq.permute(3, 0, 1, 2).reshape(cout, kk)  # [O, K], K-contiguous
    if kp > kk:
        bt = F.pad(bt, (0, kp - kk))
    a, ho, wo = _im2col(xq.contiguous(), k, stride, kp, pads)
    acc = matmul_kernel.matmul(a, bt.contiguous().t())
    return acc.reshape(xq.shape[0], ho, wo, cout)


@torch.no_grad()
def int8_conv_bn_leaky(
    h: torch.Tensor,
    block,
    out_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Quantized drop-in for an inference ``ConvBnLeaky`` ``block`` (3x3
    SAME, stride 1): weights quantized per output channel on each call,
    activations dynamically per batch, int32 accumulation, then the f32
    dequant, conv bias, BN (running statistics) and leaky, op for op as the
    JAX package's ``int8_conv_bn_leaky``."""
    wq, sw = quantize_weights_per_channel(hwio(block.conv.weight))
    xq, sx = quantize_dynamic(h)
    acc = conv_i8(xq, wq)
    y = acc.float() * (sx * sw)
    y = y + block.conv.bias.float()
    bn = block.bn
    scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    y = (y - bn.running_mean) * scale + bn.bias
    y = F.leaky_relu(y, block.negative_slope)
    return y.to(out_dtype)
