"""ctypes binding to the port's native data-loader core (``libodc_loader.so``).

A small libjpeg-based C++ library (``native/src/loader.cc``) doing JPEG
decode and bilinear resize off the Python GIL, with the cv2
``INTER_LINEAR`` fixed-point scheme (the reference resizes with cv2 and
albumentations).  It builds at first use with g++ into
``build/native/libodc_loader.so`` of the checkout; a library newer than
its source is reused.  When g++ or libjpeg is missing, :func:`available`
is False (after one warning carrying the compiler's output) and the
callers decode and resize with PIL, whose bilinear filters on downscale
and so gives other pixels.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import tempfile
import threading
import warnings
from typing import Optional, Tuple

import numpy as np

_PKG = pathlib.Path(__file__).resolve().parents[1]
SRC = _PKG / "native" / "src" / "loader.cc"
BUILD_DIR = _PKG.parent / "build" / "native"
LIB_PATH = BUILD_DIR / "libodc_loader.so"

# The coefficient positions are computed in double: other flags may contract
# them into FMAs and round a tie the other way, so these are the JAX
# package's flags verbatim.
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-pthread"]

_lib: Optional[ctypes.CDLL] = None
_load_failed = False
_lock = threading.Lock()
# Why the library could not be built or loaded (the compiler's output, or
# the loader's error); None while it can be.
load_error: Optional[str] = None


def build(lib_path=LIB_PATH, force: bool = False) -> str:
    """Compile ``loader.cc`` into ``lib_path`` unless a library newer than
    the source is there (``force``: always).  The compiler writes a
    temporary file beside it, moved into place with ``os.replace``, so a
    process or thread that loads the library at the same time never sees a
    half-written file.  Raises ``OSError`` or ``CalledProcessError`` (its
    ``stderr`` holds the compiler's output)."""
    lib_path = pathlib.Path(lib_path)
    if (not force and lib_path.exists()
            and lib_path.stat().st_mtime >= SRC.stat().st_mtime):
        return str(lib_path)
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=lib_path.parent, prefix=".loader-",
                               suffix=".so")
    os.close(fd)
    try:
        subprocess.run(
            ["g++", *_FLAGS, "-o", tmp, str(SRC), "-ljpeg"],
            check=True, capture_output=True, text=True, timeout=120,
        )
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return str(lib_path)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_int, p_int = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    p_u8 = ctypes.POINTER(ctypes.c_ubyte)
    lib.odc_jpeg_dims.argtypes = [ctypes.c_char_p, p_int, p_int]
    lib.odc_decode_jpeg.argtypes = [ctypes.c_char_p, p_u8, c_int, c_int]
    lib.odc_decode_resize_jpeg.argtypes = [
        ctypes.c_char_p, p_u8, c_int, c_int, p_int, p_int]
    lib.odc_resize_bilinear.argtypes = [
        p_u8, c_int, c_int, p_u8, c_int, c_int]
    lib.odc_decode_resize_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), c_int, p_u8, c_int, c_int,
        p_int, p_int, c_int]
    for fn in (lib.odc_jpeg_dims, lib.odc_decode_jpeg,
               lib.odc_decode_resize_jpeg, lib.odc_resize_bilinear,
               lib.odc_decode_resize_batch):
        fn.restype = c_int
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed, load_error
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is None and not _load_failed:
            try:
                _lib = _bind(ctypes.CDLL(build()))
            except subprocess.CalledProcessError as e:
                load_error = f"g++ failed:\n{e.stderr}"
            except (OSError, subprocess.SubprocessError) as e:
                load_error = f"cannot build or load {LIB_PATH}: {e}"
            if _lib is None:
                _load_failed = True
                warnings.warn(f"native loader: {load_error}\ndecoding and "
                              "resizing with PIL instead", RuntimeWarning)
    return _lib


def available() -> bool:
    return _load() is not None


def batch_available() -> bool:
    """True when the threaded batch API is there (every build of this
    source has it)."""
    return available()


def decode_jpeg(path: str) -> np.ndarray:
    """JPEG file -> RGB uint8 [H, W, 3]."""
    lib = _load()
    assert lib is not None
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.odc_jpeg_dims(path.encode(), ctypes.byref(h), ctypes.byref(w)):
        raise IOError(f"cannot read JPEG header: {path}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.odc_decode_jpeg(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        h.value, w.value)
    if rc != 0:
        raise IOError(f"JPEG decode failed ({rc}): {path}")
    return out


def decode_resize_jpeg(
    path: str, out_hw: Tuple[int, int]
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """JPEG -> bilinear-resized RGB uint8 [out_h, out_w, 3]; returns
    ``(image, (orig_h, orig_w))`` so boxes can be rescaled."""
    lib = _load()
    assert lib is not None
    oh, ow = out_hw
    out = np.empty((oh, ow, 3), np.uint8)
    src_h, src_w = ctypes.c_int(), ctypes.c_int()
    rc = lib.odc_decode_resize_jpeg(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        oh, ow, ctypes.byref(src_h), ctypes.byref(src_w))
    if rc != 0:
        raise IOError(f"JPEG decode+resize failed ({rc}): {path}")
    return out, (src_h.value, src_w.value)


def resize_bilinear(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """RGB uint8 [H, W, 3] -> bilinear-resized [out_h, out_w, 3]."""
    lib = _load()
    assert lib is not None
    img = np.ascontiguousarray(img)
    oh, ow = out_hw
    out = np.empty((oh, ow, 3), np.uint8)
    rc = lib.odc_resize_bilinear(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        img.shape[0], img.shape[1],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), oh, ow)
    if rc != 0:
        raise RuntimeError("native resize failed")
    return out


def decode_resize_batch(
    paths, out_hw: Tuple[int, int], n_threads: int = 0,
    return_status: bool = False,
):
    """N JPEG files -> ``([N, out_h, out_w, 3] RGB uint8, [N, 2] original
    (h, w))`` through the C++ thread pool (``n_threads=0``: the hardware
    threads), every decode off the GIL.  Raises on a failed image unless
    ``return_status``, which instead appends the per-image status vector
    (0 = ok) so callers can fall back file by file."""
    lib = _load()
    assert lib is not None
    n = len(paths)
    oh, ow = out_hw
    out = np.empty((n, oh, ow, 3), np.uint8)
    src_hw = np.zeros((n, 2), np.int32)
    rcs = np.zeros((n,), np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    failed = lib.odc_decode_resize_batch(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), oh, ow,
        src_hw.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        rcs.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n_threads)
    if return_status:
        return out, src_hw, rcs
    if failed:
        bad = int(np.flatnonzero(rcs)[0])
        raise IOError(
            f"batch decode: {failed}/{n} images failed "
            f"(first: {paths[bad]} rc={int(rcs[bad])})")
    return out, src_hw
