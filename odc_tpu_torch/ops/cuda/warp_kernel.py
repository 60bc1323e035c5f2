"""Two-pass affine warp: the CUDA kernel (``csrc/warp_affine.cu``), its plain
PyTorch version, and the wrapper that picks between them by device.

Replaces ``odc_tpu/ops/pallas/warp_kernel.py::warp_affine_pallas``, the
geometric backend of the in-step device augmentation.  Images
``[B, H, W, C]`` f32 or uint8 (0..255), inverse maps ``[B, 3, 3]`` and a
static ``max_shear`` give the warped ``[B, H, W, C]`` f32 batch with zero
fill: the function of ``ops/warp.py::warp_affine_twopass`` (three taps per
pass under shear), not the one-shot bilinear warp.  uint8 images give
bitwise what their f32 copy gives; the kernel converts them in registers.

Bound on the card: bytes — each image is read once and written once.  The
kernel fuses both passes in one launch: a CTA owns a 32 x 64 output tile,
stages the source rows it needs in shared memory (bulk copies of the TMA),
computes each intermediate value its columns need once into column strips
(pass X), then blends 4 adjacent outputs per thread and writes them with
16-byte stores (pass Y).  The pass coefficients
are computed in the kernel from the inverse maps, op for op as
:func:`odc_tpu_torch.ops.warp.twopass_coeffs` does, so the wrapper is one
launch and nothing else.
"""

from __future__ import annotations

import torch

from odc_tpu_torch.ops.cuda import build
from odc_tpu_torch.ops.warp import shift_kmax, warp_affine_twopass

MAX_CHANNELS = 4
MAX_IMAGE_ELEMS = 1 << 28  # H * W * C: the kernel's offsets are 32-bit
DTYPES = (torch.float32, torch.uint8)


def warp_affine_plain(
    images: torch.Tensor, m_invs: torch.Tensor, max_shear: float = 1.0
) -> torch.Tensor:
    """The kernel's function in plain PyTorch (pad, blend, rolls and
    hat-matrix products, as the JAX package computes it)."""
    return warp_affine_twopass(images, m_invs, images.shape[1:3], max_shear)


def _launch(images: torch.Tensor, m_invs: torch.Tensor, max_shear: float):
    b, h, w, ch = images.shape
    out = torch.empty(images.shape, dtype=torch.float32, device=images.device)
    if images.numel() == 0:
        return out
    lib = build.load("warp_affine")
    with torch.cuda.device(images.device):
        err = lib.warp_affine(
            images.data_ptr(), m_invs.data_ptr(), out.data_ptr(), b, h, w, ch,
            shift_kmax(h, max_shear), shift_kmax(w, max_shear),
            int(images.dtype == torch.uint8),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, "warp_affine")
    warp_affine.launches += 1
    return out


def warp_affine(
    images: torch.Tensor, m_invs: torch.Tensor, max_shear: float = 1.0
) -> torch.Tensor:
    """Batched two-pass affine warp (see :func:`warp_affine_plain`) of f32
    or uint8 images, always f32 out.

    A CPU tensor runs the plain version (on ``images.float()``); a CUDA
    tensor launches the kernel (one launch per batch, C <= 4) or raises.
    Images must start on a 16-byte boundary, as the kernel reads them in
    16-byte pieces."""
    if images.dim() != 4:
        raise ValueError(f"images must be [B, H, W, C], got {tuple(images.shape)}")
    if tuple(m_invs.shape) != (images.shape[0], 3, 3):
        raise ValueError(
            f"m_invs must be [B, 3, 3], got {tuple(m_invs.shape)} for "
            f"B={images.shape[0]}"
        )
    if images.dtype not in DTYPES or m_invs.dtype != torch.float32:
        raise TypeError(
            f"images must be float32 or uint8 and m_invs float32, got "
            f"{images.dtype} and {m_invs.dtype}"
        )
    if images.data_ptr() % 16:
        raise ValueError("images must start on a 16-byte boundary")
    if m_invs.device != images.device:
        raise ValueError("images and m_invs must be on the same device")
    if max_shear < 0:
        raise ValueError(f"max_shear must be >= 0, got {max_shear}")
    if images.device.type == "cpu":
        return warp_affine_plain(images.float(), m_invs, max_shear)
    if images.device.type != "cuda":
        raise ValueError(f"unsupported device {images.device}")
    if images.shape[-1] > MAX_CHANNELS:
        raise ValueError(
            f"C={images.shape[-1]} exceeds the kernel's {MAX_CHANNELS} channels"
        )
    if images.shape[0] > 65535:
        raise ValueError(f"B={images.shape[0]} exceeds the kernel's 65535")
    if images[0].numel() > MAX_IMAGE_ELEMS:
        raise ValueError(
            f"an image of {images[0].numel()} values exceeds the kernel's "
            f"{MAX_IMAGE_ELEMS}"
        )
    if not (images.is_contiguous() and m_invs.is_contiguous()):
        raise ValueError("images and m_invs must be contiguous")
    return _launch(images, m_invs, max_shear)


build.counted(warp_affine)
