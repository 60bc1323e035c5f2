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

from odc_tpu_torch.ops.cuda.matmul_kernel import (
    MAX_K, ROUTES, matmul, matmul_plain, route,
)

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


def _offset(rows, cols, dtype, shift):
    """A contiguous ``[rows, cols]`` tensor whose base lies ``shift`` bytes
    past an allocation's start."""
    size = torch.tensor([], dtype=dtype).element_size()
    buf = torch.zeros(rows * cols * size + shift, dtype=torch.uint8)
    return buf[shift:].view(dtype).view(rows, cols)


@pytest.mark.parametrize(
    "m, k, n, dtype, a_shift, b_shift, want",
    [
        (169, 9216, 1024, torch.int8, 0, 0, "wgmma"),      # stage-7 3x3
        (676, 288, 64, torch.int8, 0, 0, "wgmma"),         # K % 128 != 0
        (37, 32, 70, torch.int8, 0, 0, "wgmma"),           # ragged M, N
        (5, 16, 3, torch.int8, 0, 0, "wgmma"),             # smallest TMA row
        (1000, 300, 70, torch.int8, 0, 0, "mma_sync"),     # K bytes % 16 != 0
        (64, 40, 64, torch.int8, 0, 0, "mma_sync"),        # K bytes % 16 == 8
        (64, 64, 64, torch.int8, 16, 48, "wgmma"),         # 16-byte offsets
        (64, 64, 64, torch.int8, 8, 0, "mma_sync"),        # misaligned a
        (64, 64, 64, torch.int8, 0, 4, "mma_sync"),        # misaligned b
        (256, 512, 256, torch.bfloat16, 0, 0, "mma_sync"),  # bf16 stays
    ],
    ids=["large-k", "k288", "ragged-mn", "k16", "k300", "k40", "offsets16",
         "a-misaligned", "b-misaligned", "bf16"],
)
def test_route(m, k, n, dtype, a_shift, b_shift, want):
    """:func:`route` picks the wgmma + TMA kernel exactly when TMA can
    describe both operands (int8 rows of a multiple of 16 bytes, 16-byte
    aligned bases); the shape alone and nothing that happens at run time
    decides.  On the CPU the wrapper still runs the plain version."""
    a = _offset(m, k, dtype, a_shift)
    bt = _offset(n, k, dtype, b_shift)
    assert route(m, n, k, dtype, a, bt.t()) == want
    assert want in ROUTES
    counts = dict(matmul.launches_by_route)
    if m * k <= 1 << 16:
        assert matmul(a, bt.t()).shape == (m, n)
    assert matmul.launches_by_route == counts == dict.fromkeys(ROUTES, 0)


@pytest.mark.parametrize("dtype, k, path, ok", [
    (torch.int8, 64, "mma_sync", True), (torch.int8, 64, "wgmma", True),
    (torch.int8, 300, "wgmma", False), (torch.bfloat16, 64, "wgmma", False),
    (torch.int8, 64, "tma", False)],
    ids=["older-route", "picked-route", "wgmma-k300", "wgmma-bf16",
         "unknown"])
def test_explicit_route(dtype, k, path, ok):
    """``path=`` may ask for the mma.sync route on any input, and for the
    wgmma route only where :func:`route` picks it; anything else raises
    before a launch."""
    a = torch.ones(8, k, dtype=dtype)
    bt = torch.ones(4, k, dtype=dtype)
    if ok:
        assert torch.equal(matmul(a, bt.t(), path=path),
                           matmul_plain(a, bt.t()))
    else:
        with pytest.raises(ValueError, match="cannot take"):
            matmul(a, bt.t(), path=path)
