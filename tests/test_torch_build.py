"""The port's kernel build (``odc_tpu_torch/ops/cuda/build.py``) on the CPU:
which files a kernel's library depends on, and when a built library counts
as stale.  Compiling needs ``nvcc`` and runs on the card only."""

import os

import pytest

from odc_tpu_torch.ops.cuda import build


def test_sources_of_every_kernel_exist():
    """Every kernel's dependencies are files of ``csrc``; the GEMM's include
    the shared Hopper helpers."""
    for name in build.SOURCES:
        deps = build.sources_of(name)
        assert deps[0] == build.CSRC / build.SOURCES[name][0]
        assert all(p.is_file() for p in deps)
    assert build.CSRC / "hopper.cuh" in build.sources_of("int8_matmul")


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """A kernel ``toy.cu`` that includes ``a.cuh``, which includes
    ``b.cuh``, with its library already built."""
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    out.mkdir()
    (csrc / "toy.cu").write_text('#include <stdint.h>\n#include "a.cuh"\n')
    (csrc / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n')
    (csrc / "b.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", out)
    monkeypatch.setitem(build.SOURCES, "toy", ("toy.cu", []))
    lib = build.lib_path("toy")
    lib.write_bytes(b"")
    for path in (csrc / "toy.cu", csrc / "a.cuh", csrc / "b.cuh"):
        os.utime(path, (1000, 1000))
    os.utime(lib, (2000, 2000))
    return csrc, lib


def test_sources_of_follows_includes(toy):
    csrc, _ = toy
    assert build.sources_of("toy") == [
        csrc / "toy.cu", csrc / "a.cuh", csrc / "b.cuh"]


@pytest.mark.parametrize("touched", [None, "toy.cu", "a.cuh", "b.cuh", "lib"])
def test_fresh_compares_the_library_with_every_dependency(toy, touched):
    """A library older than its source or than any header the source
    includes, directly or not, is rebuilt; a missing one too."""
    csrc, lib = toy
    if touched == "lib":
        lib.unlink()
    elif touched is not None:
        os.utime(csrc / touched, (3000, 3000))
    assert build._fresh("toy") == (touched is None)
