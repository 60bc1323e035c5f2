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

Bound on the card: the engine's 20 GEMMs of a batch-64 call do 2.21e12
int8 operations (1.12 ms at 1,979 TOPS) on about 5.9 GB of operands and
results (1.76 ms at 3.35 TB/s); per GEMM the larger term sums to 2.14 ms.
Two routes, picked by :func:`route` from shape, type and alignment alone:

* ``"wgmma"`` (int8, ``K`` a multiple of 16, both bases 16-byte aligned,
  which every GEMM of the engine meets): TMA loads into a ring of
  shared-memory stages, a producer warp and two consumer warpgroups running
  ``wgmma`` m64nNk32 s8, persistent CTAs over 128 x N tiles;
* ``"mma_sync"`` (bf16, and int8 shapes TMA cannot describe): 64-byte K
  slices staged through registers, ``mma.sync`` m16n8k32 s8 / m16n8k16
  bf16.

Both are exact for int8, so the result does not depend on the route.
"""

from __future__ import annotations

from typing import Optional

import torch

from odc_tpu_torch.ops.cuda import build

# Longest contraction the int32 sums provably hold: 128 * 127 * K < 2**31.
MAX_K = 131072
_LAUNCHERS = {torch.int8: "matmul_s8s8s32", torch.bfloat16: "matmul_bf16bf16f32"}
OUT_DTYPE = {torch.int8: torch.int32, torch.bfloat16: torch.float32}
ROUTES = ("wgmma", "mma_sync")


def route(m: int, n: int, k: int, dtype: torch.dtype, a: torch.Tensor,
          b: torch.Tensor) -> str:
    """The kernel route for ``a [m, k] @ b [k, n]`` on the card: ``"wgmma"``
    when TMA can describe both operands (int8, rows of a multiple of 16
    bytes, 16-byte aligned bases of ``a`` and of ``b``'s ``[N, K]`` storage),
    else ``"mma_sync"``.  Depends on nothing but its arguments."""
    del m, n  # any M, N: TMA fills the ragged edges with zeros
    aligned = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    if dtype == torch.int8 and k % 16 == 0 and aligned:
        return "wgmma"
    return "mma_sync"


def matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch.  int8: the product in float64
    cast to int32, exact because every partial sum is an integer below
    2**53; bf16: the product of the f32 upcasts."""
    if a.dtype == torch.int8:
        return (a.double() @ b.double()).to(torch.int32)
    return a.float() @ b.float()


def _launch(a: torch.Tensor, b: torch.Tensor, path: str) -> torch.Tensor:
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=OUT_DTYPE[a.dtype], device=a.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    lib = build.load("int8_matmul")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        if path == "wgmma":
            err = lib.matmul_s8s8s32_wgmma(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, stream)
        else:
            kb = k * a.element_size()
            vec = (kb % 16 == 0 and a.data_ptr() % 16 == 0
                   and b.data_ptr() % 16 == 0)
            err = getattr(lib, _LAUNCHERS[a.dtype])(
                a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, int(vec),
                stream)
    build.check(err, "int8_matmul")
    matmul.launches += 1
    matmul.launches_by_route[path] += 1
    return out


def matmul(a: torch.Tensor, b: torch.Tensor,
           path: Optional[str] = None) -> torch.Tensor:
    """``a [M, K] @ b [K, N]``: int8 -> int32 (exact) or bf16 -> f32.

    ``a`` must be contiguous and ``b`` the transpose of a contiguous
    ``[N, K]`` tensor.  Calls the operator ``odc_tpu_torch::int8_matmul``
    (``ops.py``): a CPU tensor runs :func:`matmul_plain`; a CUDA tensor
    launches the kernel on the route :func:`route` picks, or raises.
    ``path="mma_sync"`` asks for the older route on any input (to compare
    the two on the card); ``path="wgmma"`` only where :func:`route` allows
    it."""
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
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a.device}")
    if path not in (None,) + ROUTES:
        raise ValueError(f"route {path!r} cannot take this input (routes: "
                         f"{ROUTES})")
    return torch.ops.odc_tpu_torch.int8_matmul(a, b, path)


build.counted(matmul)
matmul.launches_by_route = dict.fromkeys(ROUTES, 0)
