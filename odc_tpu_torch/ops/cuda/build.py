"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface and compiles on its own
with ``nvcc`` for ``sm_90a`` into a shared library under ``build/cuda/`` of
the checkout, which ``ctypes`` then loads.  The build happens at first use
(or up front through :func:`build_all`, which starts one ``nvcc`` per source
in parallel); a library newer than its source and every ``csrc`` header the
source includes is reused.  A failed build
raises with the compiler's output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import re
import shutil
import subprocess
import threading
from typing import Dict, List, Optional

_PKG = pathlib.Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "cuda"

# name -> (source, extra nvcc flags).  ``-fmad=false`` keeps the NMS IoU
# bitwise equal to the plain PyTorch version: a contracted a*b+c rounds once
# where PyTorch rounds twice, and an IoU exactly at the threshold would flip.
# The warp takes it for its sample positions (slope*o + offset), whose last
# bit decides tap fractions on images with steep steps; the conv blocks'
# epilogue for BN's (x - mean) * inv * weight + shift, which ATen rounds op
# by op.  The Mish epilogue keeps contraction on, as ATen compiles its Mish
# (expf, log1pf, tanhf inlined from the CUDA math library), and rounds its BN
# op by op with __fadd_rn / __fmul_rn instead.
SOURCES: Dict[str, tuple] = {
    "nms_suppress": ("nms_suppress.cu", ["-fmad=false"]),
    "superstem": ("superstem.cu", []),
    "warp_affine": ("warp_affine.cu", ["-fmad=false"]),
    # -ldl: the wgmma route looks up cuTensorMapEncodeTiled with dlsym.
    "int8_matmul": ("int8_matmul.cu", ["-ldl"]),
    "bias_bn_leaky": ("bias_bn_leaky.cu", ["-fmad=false"]),
    "bias_bn_mish": ("bias_bn_mish.cu", []),
}

_P, _I = ctypes.c_void_p, ctypes.c_int
# Every exported launcher: pointers and the stream as c_void_p (ctypes would
# cut a Python int to 32 bits otherwise); each returns its cudaError_t.
SIGNATURES: Dict[str, Dict[str, list]] = {
    "nms_suppress": {
        "nms_suppress": [_P, _P, _P, _I, _I, ctypes.c_float, _P],
        "nms_launch_floor": [_I, _I, _P],
    },
    "superstem": {
        "superstem_bf16": [_P, _P, _P, _P, _I, _I, _I, _P],
        "superstem_f32": [_P, _P, _P, _P, _I, _I, _I, _P],
    },
    "warp_affine": {
        "warp_affine": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    },
    "int8_matmul": {
        "matmul_s8s8s32": [_P, _P, _P, _I, _I, _I, _I, _P],
        "matmul_s8s8s32_wgmma": [_P, _P, _P, _I, _I, _I, _P],
        "matmul_bf16bf16f32": [_P, _P, _P, _I, _I, _I, _I, _P],
    },
    "bias_bn_leaky": {
        "bias_bn_leaky_bf16": [_P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong,
                               _I, ctypes.c_float, ctypes.c_float, _P],
    },
    "bias_bn_mish": {
        "bias_bn_mish_bf16": [_P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong,
                              _I, ctypes.c_float, _P],
        "bias_bn_mish_table": [ctypes.c_uint, ctypes.c_longlong, _P, _P],
    },
}

_BASE_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_loaded: Dict[str, ctypes.CDLL] = {}
# A serving worker thread may launch the first kernel while another thread
# does too: one builds and loads, the other waits.
_load_lock = threading.Lock()


def nvcc_path() -> str:
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def lib_path(name: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{name}.so"


_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources_of(name: str) -> List[pathlib.Path]:
    """The ``.cu`` file of kernel ``name`` and every file it includes with
    ``#include "..."`` from ``csrc``, transitively."""
    todo, seen = [CSRC / SOURCES[name][0]], []
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        todo += [CSRC / inc for inc in _INCLUDE.findall(path.read_text())]
    return seen


def _fresh(name: str) -> bool:
    out = lib_path(name)
    return out.exists() and all(
        out.stat().st_mtime >= src.stat().st_mtime for src in sources_of(name))


def _command(name: str, out: pathlib.Path, verbose: bool) -> List[str]:
    src, extra = SOURCES[name]
    cmd = [nvcc_path(), *_BASE_FLAGS, *extra]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    return cmd + ["-o", str(out), str(CSRC / src)]


def build_all(
    names: Optional[List[str]] = None, verbose: bool = False
) -> Dict[str, str]:
    """Compile the named kernels (default: all), one ``nvcc`` per source,
    all started together; ``verbose`` adds ``-Xptxas -v``.  Returns
    ``{name: compiler output}``; raises ``RuntimeError`` with the output of
    every failed build."""
    names = list(SOURCES) if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        tmp = BUILD_DIR / f".lib{name}.{os.getpid()}.so"
        procs[name] = (
            subprocess.Popen(
                _command(name, tmp, verbose),
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
        )
    logs, failed = {}, []
    for name, (proc, tmp) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib_path(name))
    if failed:
        raise RuntimeError(
            "nvcc failed for "
            + ", ".join(failed)
            + "\n"
            + "\n".join(f"--- {n}\n{logs[n]}" for n in failed)
        )
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if missing or stale.
    Thread-safe."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _load_lock:
        lib = _loaded.get(name)
        if lib is None:
            if not _fresh(name):
                build_all([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            for fn_name, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


# Every kernel wrapper that counts its launches (:func:`counted`): a CUDA
# graph replay adds the launches it captured to each of them.
COUNTED: List = []


def counted(wrapper):
    """Register ``wrapper`` as counting its kernel's launches in
    ``wrapper.launches`` (starting at 0); returns it."""
    wrapper.launches = 0
    COUNTED.append(wrapper)
    return wrapper
