"""Tiled matrix product: the CUDA kernel (``csrc/int8_matmul.cu``), its plain
PyTorch version, and the wrapper that picks between them by device.

Replaces ``scripts/probe_int8_mxu.py::pallas_matmul`` (body ``_mm_kernel``),
the TPU kernel written to run the int8 PTQ engine's convolutions as im2col
GEMMs.  ``C = A @ B`` with the probe's dtype rule: int8 operands give an
exact int32 result, bf16 operands an f32 result summed in f32.  Unlike the
TPU kernel, any M, N and K are accepted; the kernel masks the ragged edges.

Layout: ``a`` is row-major ``[M, K]``; ``b`` is ``[K, N]`` stored
column-major, i.e. the transpose of a contiguous ``[N, K]`` tensor
(``b = bt.t()``), so that both operands are contiguous along K.  A conv's
weight ``[O, kh, kw, I]`` reshaped to ``[O, K]`` is that ``bt``.

Bound on the card: operations at the int8 tensor-core rate (2.21e12 a
batch-64 call of the engine, 1.12 ms at 1,979 TOPS), but the im2col
matrices that feed it are about 9.0 GB a call (2.7 ms at 3.35 TB/s), so the
engine's path is bound by bytes.  The kernel stages 64-byte slices of K of
both operands in shared memory and accumulates in registers with
``mma.sync`` (m16n8k32 s8 or m16n8k16 bf16): simple and exact, not yet
``wgmma``/TMA or an implicit GEMM.
"""

from __future__ import annotations

import torch

from odc_tpu_torch.ops.cuda import build

# Longest contraction the int32 sums provably hold: 128 * 127 * K < 2**31.
MAX_K = 131072
_LAUNCHERS = {torch.int8: "matmul_s8s8s32", torch.bfloat16: "matmul_bf16bf16f32"}
_OUT = {torch.int8: torch.int32, torch.bfloat16: torch.float32}


def matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch.  int8: the product in float64
    cast to int32, exact because every partial sum is an integer below
    2**53; bf16: the product of the f32 upcasts."""
    if a.dtype == torch.int8:
        return (a.double() @ b.double()).to(torch.int32)
    return a.float() @ b.float()


def _launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=_OUT[a.dtype], device=a.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    kb = k * a.element_size()
    vec = kb % 16 == 0 and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    lib = build.load("int8_matmul")
    with torch.cuda.device(a.device):
        err = getattr(lib, _LAUNCHERS[a.dtype])(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, int(vec),
            torch.cuda.current_stream().cuda_stream,
        )
    build.check(err, "int8_matmul")
    matmul.launches += 1
    return out


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [M, K] @ b [K, N]``: int8 -> int32 (exact) or bf16 -> f32.

    ``a`` must be contiguous and ``b`` the transpose of a contiguous
    ``[N, K]`` tensor.  A CPU tensor runs :func:`matmul_plain`; a CUDA
    tensor launches the kernel or raises."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(
            f"need a [M, K] and b [K, N], got {tuple(a.shape)} and "
            f"{tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _LAUNCHERS:
        raise TypeError(
            f"a and b must both be int8 or both bf16, got {a.dtype} and "
            f"{b.dtype}")
    if a.shape[1] > MAX_K:
        raise ValueError(f"K={a.shape[1]} exceeds {MAX_K}: int32 sums could "
                         "overflow")
    if a.device != b.device:
        raise ValueError("a and b must be on the same device")
    if not (a.is_contiguous() and b.t().is_contiguous()):
        raise ValueError("a must be contiguous and b the transpose of a "
                         "contiguous [N, K] tensor (b = bt.t())")
    if a.device.type == "cpu":
        return matmul_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    return _launch(a, b)


matmul.launches = 0
