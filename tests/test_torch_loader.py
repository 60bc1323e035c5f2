"""The port's C++ loader (``odc_tpu_torch/native``) against the JAX
package's and against numpy oracles: decode, the cv2 ``INTER_LINEAR``
fixed-point resize (bitwise), the threaded batch API, per-file failures,
and concurrent builds.  Both libraries are built by g++ at first use."""

import os
import pathlib
import threading

import numpy as np
import pytest
from PIL import Image

from cv2_resize_oracle import resize_inter_linear
from odc_tpu.native import loader as jloader
from odc_tpu_torch.native import loader


@pytest.fixture(scope="module", autouse=True)
def built():
    """Both loaders build here (g++ and libjpeg are present): a missing one
    would silently send every parity test below to PIL."""
    assert loader.available() and jloader.available()
    repo = pathlib.Path(__file__).resolve().parents[1]
    assert loader.LIB_PATH == repo / "build" / "native" / "libodc_loader.so"
    assert loader.LIB_PATH.exists()


def _jpeg(path, shape, seed, quality=90):
    img = np.random.default_rng(seed).integers(0, 255, shape, dtype=np.uint8)
    Image.fromarray(img).save(path, quality=quality)
    return str(path)


def test_decode_matches_jax_and_pil(tmp_path):
    p = _jpeg(tmp_path / "x.jpg", (37, 53, 3), 0, quality=90)
    ours = loader.decode_jpeg(p)
    np.testing.assert_array_equal(ours, jloader.decode_jpeg(p))
    np.testing.assert_array_equal(ours, np.asarray(Image.open(p).convert("RGB")))


@pytest.mark.parametrize("src_hw, out_hw", [
    ((375, 500), (416, 416)),
    ((375, 500), (224, 224)),
    ((375, 500), (64, 64)),
    ((500, 375), (416, 416)),
])
def test_resize_bitwise_matches_jax_and_cv2_scheme(src_hw, out_hw):
    """Bitwise, not a tolerance: the JAX binding's library and the numpy
    reimplementation of cv2's scalar fixed-point scheme."""
    src = np.random.default_rng(7).integers(0, 255, src_hw + (3,),
                                            dtype=np.uint8)
    ours = loader.resize_bilinear(src, out_hw)
    assert ours.shape == out_hw + (3,) and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, jloader.resize_bilinear(src, out_hw))
    np.testing.assert_array_equal(ours, resize_inter_linear(src, *out_hw))


def test_decode_resize_fused_equals_two_steps(tmp_path):
    p = _jpeg(tmp_path / "y.jpg", (60, 80, 3), 2, quality=95)
    out, src_hw = loader.decode_resize_jpeg(p, (30, 40))
    assert src_hw == (60, 80)
    np.testing.assert_array_equal(
        out, loader.resize_bilinear(loader.decode_jpeg(p), (30, 40)))
    np.testing.assert_array_equal(out, jloader.decode_resize_jpeg(p, (30, 40))[0])


def test_batch_equals_sequential(tmp_path):
    rng = np.random.default_rng(0)
    paths = [
        _jpeg(tmp_path / f"{i}.jpg",
              (int(rng.integers(40, 200)), int(rng.integers(40, 200)), 3), i)
        for i in range(7)
    ]
    imgs, src_hw = loader.decode_resize_batch(paths, (64, 96), n_threads=4)
    for i, p in enumerate(paths):
        ref_img, ref_hw = loader.decode_resize_jpeg(p, (64, 96))
        np.testing.assert_array_equal(imgs[i], ref_img)
        assert tuple(src_hw[i]) == ref_hw
    j_imgs, j_hw = jloader.decode_resize_batch(paths, (64, 96), n_threads=4)
    np.testing.assert_array_equal(imgs, j_imgs)
    np.testing.assert_array_equal(src_hw, j_hw)


def test_failures_surface_per_file(tmp_path):
    """A corrupt JPEG, a PNG and a missing file: per-file status codes as
    the JAX binding gives them with ``return_status``, an ``IOError``
    without it, and from the single-file calls."""
    good = _jpeg(tmp_path / "ok.jpg", (16, 24, 3), 1)
    corrupt = tmp_path / "bad.jpg"
    corrupt.write_bytes(pathlib.Path(good).read_bytes()[:40])
    png = tmp_path / "img.jpg"
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(png, format="PNG")
    paths = [good, str(corrupt), str(png), str(tmp_path / "missing.jpg")]
    out, src_hw, rcs = loader.decode_resize_batch(paths, (8, 8),
                                                  return_status=True)
    j_out, j_hw, j_rcs = jloader.decode_resize_batch(paths, (8, 8),
                                                     return_status=True)
    assert rcs[0] == 0 and (rcs[1:] != 0).all()
    np.testing.assert_array_equal(rcs, j_rcs)
    np.testing.assert_array_equal(out[0], j_out[0])
    with pytest.raises(IOError, match="3/4 images failed"):
        loader.decode_resize_batch(paths, (8, 8))
    for p in paths[1:]:
        with pytest.raises(IOError):
            loader.decode_jpeg(p)
        with pytest.raises(IOError):
            loader.decode_resize_jpeg(p, (8, 8))


def test_concurrent_builds_load_a_sound_library(tmp_path):
    """Two threads compile into the same path at once: each writes its own
    temporary file and moves it into place, so both end with a library
    that loads and resizes bitwise as the shared one does."""
    target = tmp_path / "lib" / "libodc_loader.so"
    src = np.random.default_rng(3).integers(0, 255, (50, 70, 3), np.uint8)
    want = loader.resize_bilinear(src, (31, 17))
    results, errors = [], []
    start = threading.Barrier(2)

    def build_and_load():
        try:
            start.wait()
            lib = loader._bind(loader.ctypes.CDLL(
                loader.build(target, force=True)))
            out = np.empty((31, 17, 3), np.uint8)
            u8 = loader.ctypes.POINTER(loader.ctypes.c_ubyte)
            rc = lib.odc_resize_bilinear(
                src.ctypes.data_as(u8), 50, 70, out.ctypes.data_as(u8), 31, 17)
            results.append((rc, out))
        except BaseException as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=build_and_load) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert len(results) == 2
    for rc, out in results:
        assert rc == 0
        np.testing.assert_array_equal(out, want)
    assert os.listdir(target.parent) == [target.name]  # no temporary left
    # A library newer than its source is reused, not rebuilt.
    mtime = target.stat().st_mtime_ns
    loader.build(target)
    assert target.stat().st_mtime_ns == mtime
