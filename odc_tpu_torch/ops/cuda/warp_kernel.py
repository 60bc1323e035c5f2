"""Two-pass affine warp: the CUDA kernel (``csrc/warp_affine.cu``), its plain
PyTorch version, and the wrapper that picks between them by device.

Replaces ``odc_tpu/ops/pallas/warp_kernel.py::warp_affine_pallas``, the
geometric backend of the in-step device augmentation.  Images
``[B, H, W, C]`` f32 (0..255), inverse maps ``[B, 3, 3]`` and a static
``max_shear`` give the warped ``[B, H, W, C]`` f32 batch with zero fill: the
function of ``ops/warp.py::warp_affine_twopass`` (three taps per pass under
shear), not the one-shot bilinear warp.

Bound on the card: bytes — each image is read once and written once.  The
kernel fuses both passes in one launch: a thread owns one output pixel,
reads its nine source taps directly and keeps the intermediate plane out of
memory.  The pass coefficients are computed in the kernel from the inverse
maps, op for op as :func:`odc_tpu_torch.ops.warp.twopass_coeffs` does, so
the wrapper is one launch and nothing else.
"""

from __future__ import annotations

import torch

from odc_tpu_torch.ops.cuda import build
from odc_tpu_torch.ops.warp import shift_kmax, warp_affine_twopass

MAX_CHANNELS = 4


def warp_affine_plain(
    images: torch.Tensor, m_invs: torch.Tensor, max_shear: float = 1.0
) -> torch.Tensor:
    """The kernel's function in plain PyTorch (pad, blend, rolls and
    hat-matrix products, as the JAX package computes it)."""
    return warp_affine_twopass(images, m_invs, images.shape[1:3], max_shear)


def _launch(images: torch.Tensor, m_invs: torch.Tensor, max_shear: float):
    b, h, w, ch = images.shape
    out = torch.empty_like(images)
    if images.numel() == 0:
        return out
    lib = build.load("warp_affine")
    with torch.cuda.device(images.device):
        err = lib.warp_affine(
            images.data_ptr(), m_invs.data_ptr(), out.data_ptr(), b, h, w, ch,
            shift_kmax(h, max_shear), shift_kmax(w, max_shear),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, "warp_affine")
    warp_affine.launches += 1
    return out


def warp_affine(
    images: torch.Tensor, m_invs: torch.Tensor, max_shear: float = 1.0
) -> torch.Tensor:
    """Batched two-pass affine warp (see :func:`warp_affine_plain`).

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (one launch per batch, C <= 4) or raises."""
    if images.dim() != 4:
        raise ValueError(f"images must be [B, H, W, C], got {tuple(images.shape)}")
    if tuple(m_invs.shape) != (images.shape[0], 3, 3):
        raise ValueError(
            f"m_invs must be [B, 3, 3], got {tuple(m_invs.shape)} for "
            f"B={images.shape[0]}"
        )
    if images.dtype != torch.float32 or m_invs.dtype != torch.float32:
        raise TypeError(
            f"images and m_invs must be float32, got {images.dtype} and "
            f"{m_invs.dtype}"
        )
    if m_invs.device != images.device:
        raise ValueError("images and m_invs must be on the same device")
    if max_shear < 0:
        raise ValueError(f"max_shear must be >= 0, got {max_shear}")
    if images.device.type == "cpu":
        return warp_affine_plain(images, m_invs, max_shear)
    if images.device.type != "cuda":
        raise ValueError(f"unsupported device {images.device}")
    if images.shape[-1] > MAX_CHANNELS:
        raise ValueError(
            f"C={images.shape[-1]} exceeds the kernel's {MAX_CHANNELS} channels"
        )
    if images.shape[0] > 65535:
        raise ValueError(f"B={images.shape[0]} exceeds the kernel's 65535")
    if not (images.is_contiguous() and m_invs.is_contiguous()):
        raise ValueError("images and m_invs must be contiguous")
    return _launch(images, m_invs, max_shear)


warp_affine.launches = 0
