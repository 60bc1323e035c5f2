"""The port's GEMM (``odc_tpu_torch/ops/cuda/matmul_kernel.py``) against the
TPU kernel it replaces, ``scripts/probe_int8_mxu.py::pallas_matmul`` run in
Pallas interpret mode on the CPU, and against the probe's own XLA reference
(``dot_general``); plus the wrapper's input checks.  On the CPU the wrapper
runs its plain version; the CUDA kernel itself is held against that plain
version on the card by ``chip_smoke.py``."""

import importlib.util
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from odc_tpu_torch.ops.cuda.matmul_kernel import MAX_K, matmul, matmul_plain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def probe():
    """``scripts/probe_int8_mxu.py`` as a module (``scripts`` is no package)."""
    spec = importlib.util.spec_from_file_location(
        "probe_int8_mxu", os.path.join(REPO, "scripts", "probe_int8_mxu.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _operands(rng, m, k, n, dtype):
    """(numpy a [M, K], numpy b [K, N]) with int8 codes over the full range
    or bf16-representable normals."""
    if dtype == "int8":
        return (rng.integers(-128, 128, (m, k)).astype(np.int8),
                rng.integers(-127, 128, (k, n)).astype(np.int8))
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    to_bf16 = lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    return to_bf16(a), to_bf16(b)


def _port(a, b, dtype):
    """The port's ``matmul`` on the CPU, b passed column-major."""
    tdt = torch.int8 if dtype == "int8" else torch.bfloat16
    ta = torch.tensor(a).to(tdt)
    tbt = torch.tensor(np.ascontiguousarray(b.T)).to(tdt)
    launches = matmul.launches
    out = matmul(ta, tbt.t())
    assert matmul.launches == launches  # CPU: the plain version, no launch
    return out


def _bf16_tol(a, b):
    """f32 summation over K terms: |err| <= K * 2**-24 * (|a| @ |b|), far
    above what either side reaches (measured below 1e-6 of |a| @ |b|)."""
    k = a.shape[1]
    return k * 2.0 ** -24 * (np.abs(a).astype(np.float64) @ np.abs(b))


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_plain_matches_pallas_matmul_interpret(probe, dtype):
    """int8 bitwise (int32 sums are exact), bf16 within f32 summation noise
    of the TPU kernel run in interpret mode, 256 x 512 x 256 over a 2x2x2
    grid of 128 x 256 x 128 blocks (the probe's 512/1536/512 tiles would
    make a one-block grid here)."""
    rng = np.random.default_rng(0 if dtype == "int8" else 1)
    a, b = _operands(rng, 256, 512, 256, dtype)
    jdt = jnp.int8 if dtype == "int8" else jnp.bfloat16
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(probe.pallas_matmul(
            jnp.asarray(a, jdt), jnp.asarray(b, jdt), bm=128, bk=256, bn=128))
    got = _port(a, b, dtype).numpy()
    assert got.dtype == ref.dtype == (np.int32 if dtype == "int8" else np.float32)
    if dtype == "int8":
        np.testing.assert_array_equal(got, ref)
        exact = a.astype(np.float64) @ b.astype(np.float64)
        np.testing.assert_array_equal(got, exact.astype(np.int32))
    else:
        err = np.abs(got.astype(np.float64) - ref)
        assert (err <= _bf16_tol(a, b)).all(), err.max()


@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_plain_matches_dot_general_ragged(dtype):
    """A ragged shape (no dimension a multiple of a tile) against the
    probe's own reference, ``dot_general`` with an int32 (f32) result."""
    rng = np.random.default_rng(2)
    a, b = _operands(rng, 37, 300, 70, dtype)
    jdt, out = ((jnp.int8, jnp.int32) if dtype == "int8"
                else (jnp.bfloat16, jnp.float32))
    ref = np.asarray(jax.lax.dot_general(
        jnp.asarray(a, jdt), jnp.asarray(b, jdt), (((1,), (0,)), ((), ())),
        preferred_element_type=out))
    got = _port(a, b, dtype).numpy()
    if dtype == "int8":
        np.testing.assert_array_equal(got, ref)
    else:
        err = np.abs(got.astype(np.float64) - ref)
        assert (err <= _bf16_tol(a, b)).all(), err.max()


def test_plain_is_exact_at_the_int32_edge():
    """The largest sums the kernel is specified for stay exact in the plain
    version: every product at -128 * 127 over K = MAX_K."""
    a = torch.full((2, MAX_K), -128, dtype=torch.int8)
    bt = torch.full((3, MAX_K), 127, dtype=torch.int8)
    got = matmul(a, bt.t())
    assert got.dtype == torch.int32
    assert bool((got == -128 * 127 * MAX_K).all())
    assert int(matmul_plain(a[:, :1], bt[:, :1].t())[0, 0]) == -128 * 127


@pytest.mark.parametrize(
    "make, error, match",
    [
        (lambda: (torch.zeros(4, 8, dtype=torch.int8),
                  torch.zeros(6, 4, dtype=torch.int8).t()), ValueError, "K"),
        (lambda: (torch.zeros(4, 8, dtype=torch.int8),
                  torch.zeros(4, 8, dtype=torch.bfloat16).t()), TypeError,
         "int8"),
        (lambda: (torch.zeros(4, 8), torch.zeros(4, 8).t()), TypeError, "bf16"),
        (lambda: (torch.zeros(4, 8, dtype=torch.int8),
                  torch.zeros(8, 4, dtype=torch.int8)), ValueError,
         "transpose"),
        (lambda: (torch.zeros(8, 4, dtype=torch.int8).t(),
                  torch.zeros(4, 8, dtype=torch.int8).t()), ValueError,
         "contiguous"),
        (lambda: (torch.zeros(2, MAX_K + 1, dtype=torch.int8),
                  torch.zeros(2, MAX_K + 1, dtype=torch.int8).t()),
         ValueError, "exceeds"),
        (lambda: (torch.zeros(2, 3, 4, dtype=torch.int8),
                  torch.zeros(4, 4, dtype=torch.int8)), ValueError, "M, K"),
        (lambda: (torch.zeros(4, 8, dtype=torch.int8),
                  torch.zeros(4, 8, dtype=torch.int8, device="meta").t()),
         ValueError, "same device"),
        (lambda: (torch.zeros(4, 8, dtype=torch.int8, device="meta"),
                  torch.zeros(4, 8, dtype=torch.int8, device="meta").t()),
         ValueError, "unsupported device"),
    ],
    ids=["k-mismatch", "mixed-types", "f32", "row-major-b", "strided-a",
         "k-too-long", "3d", "devices", "meta"],
)
def test_wrapper_rejects(make, error, match):
    a, b = make()
    with pytest.raises(error, match=match):
        matmul(a, b)


def test_empty_shapes():
    """M, N or K of zero give the right empty or zero result."""
    a = torch.zeros(0, 8, dtype=torch.int8)
    assert matmul(a, torch.zeros(5, 8, dtype=torch.int8).t()).shape == (0, 5)
    z = matmul(torch.zeros(3, 0, dtype=torch.bfloat16),
               torch.zeros(2, 0, dtype=torch.bfloat16).t())
    assert z.dtype == torch.float32 and torch.equal(z, torch.zeros(3, 2))
