"""The port's affine warps (``odc_tpu_torch.ops.warp`` and the plain version
of the CUDA kernel, ``ops.cuda.warp_kernel.warp_affine_plain``) against the
JAX package on the CPU: the two-pass function, the Pallas kernel in interpret
mode, the one-shot oracle, and the pass coefficients."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from odc_tpu.ops import warp as jwarp
from odc_tpu.ops.pallas.warp_kernel import warp_affine_pallas
from odc_tpu_torch.ops import warp as twarp
from odc_tpu_torch.ops.cuda.warp_kernel import warp_affine, warp_affine_plain

H, W = 64, 96


def _minv(theta=0.0, scale=1.0, tx=0.0, ty=0.0, fx=1.0, fy=1.0):
    """The inverse map of ``tests/test_warp.py``."""
    cos, sin = np.cos(theta), np.sin(theta)
    a = scale * cos * fx
    b = -scale * sin * fy
    c = scale * sin * fx
    d = scale * cos * fy
    cx, cy = (W - 1) / 2, (H - 1) / 2
    m = np.array(
        [[a, b, cx + tx - a * cx - b * cy],
         [c, d, cy + ty - c * cx - d * cy],
         [0, 0, 1]]
    )
    return np.linalg.inv(m).astype(np.float32)


# The matrices of tests/test_warp.py, plus +-45 degrees at scale 0.8 and 1.2.
CASES = [
    dict(theta=np.deg2rad(30)),
    dict(theta=np.deg2rad(45)),
    dict(theta=np.deg2rad(-45), scale=0.85, tx=8, ty=-6, fy=-1.0),
    dict(theta=np.deg2rad(45), scale=1.2, tx=-10, ty=4, fx=-1.0),
    dict(theta=np.deg2rad(-12), scale=1.1, tx=3.3, ty=7.7),
    {},
    dict(fx=-1.0),
    dict(fy=-1.0),
    dict(scale=1.17, tx=5.3, ty=-3.7),
    dict(scale=0.8, fx=-1.0, tx=-9.9),
    dict(theta=np.deg2rad(-30), scale=1.1, tx=4),
    dict(theta=np.deg2rad(44), ty=-6),
    dict(theta=np.deg2rad(45), scale=0.8),
    dict(theta=np.deg2rad(-45), scale=0.8),
    dict(theta=np.deg2rad(45), scale=1.2),
    dict(theta=np.deg2rad(-45), scale=1.2),
]
ROTATED = [kw for kw in CASES if kw.get("theta")]


def _smooth():
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    return np.stack(
        [
            128 + 100 * np.sin(xx / 13) * np.cos(yy / 9),
            128 + 110 * np.cos(xx / 19 + yy / 11),
            (xx + yy) * 255 / (H + W),
        ],
        -1,
    ).astype(np.float32)


def _noise():
    return np.random.default_rng(0).uniform(0, 255, (H, W, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def batch():
    """(images [2N, H, W, 3], m_invs [2N, 3, 3]): every case on a smooth
    image and on uniform noise (255-level steps between neighbours)."""
    mis = np.stack([_minv(**kw) for kw in CASES])
    n = len(CASES)
    images = np.concatenate(
        [np.stack([_smooth()] * n), np.stack([_noise()] * n)]
    )
    return images, np.concatenate([mis, mis])


@pytest.fixture(scope="module")
def plain_out(batch):
    images, mis = batch
    return warp_affine_plain(torch.tensor(images), torch.tensor(mis)).numpy()


def test_plain_matches_jax_twopass(batch, plain_out):
    """atol 5e-3 on 0..255 (measured: 1.6e-5 smooth, 3.1e-5 noise): both
    run the same f32 steps; only the hat product's summation differs."""
    images, mis = batch
    ref = np.asarray(
        jax.vmap(lambda im, mi: jwarp.warp_affine_twopass(im, mi, (H, W)))(
            jnp.asarray(images), jnp.asarray(mis)
        )
    )
    np.testing.assert_allclose(plain_out, ref, atol=5e-3, rtol=0)


def test_plain_matches_pallas_interpret(batch, plain_out):
    """Against the TPU kernel itself, run as ``tests/test_warp.py`` runs it
    on the CPU (interpret mode), atol 5e-3."""
    images, mis = batch
    ref = np.asarray(
        warp_affine_pallas(jnp.asarray(images), jnp.asarray(mis), interpret=True)
    )
    np.testing.assert_allclose(plain_out, ref, atol=5e-3, rtol=0)


def test_wrapper_runs_plain_on_cpu_and_counts_nothing(batch, plain_out):
    images, mis = batch
    before = warp_affine.launches
    out = warp_affine(torch.tensor(images), torch.tensor(mis)).numpy()
    np.testing.assert_array_equal(out, plain_out)
    assert warp_affine.launches == before  # no kernel launch on the CPU
    with pytest.raises(TypeError):
        warp_affine(torch.tensor(images).double(), torch.tensor(mis))
    with pytest.raises(ValueError):
        warp_affine(torch.tensor(images), torch.tensor(mis[:3]))


@pytest.mark.parametrize("max_shear", [0.3, 1.25])
def test_max_shear_matches_jax(max_shear):
    """The static shift bound changes the canvas, not the result, while
    the slopes stay inside it (|tan 12 deg| = 0.21)."""
    kw = dict(theta=np.deg2rad(-12), scale=1.1, tx=3.3, ty=7.7)
    mi = _minv(**kw)
    img = _noise()
    out = twarp.warp_affine_twopass(
        torch.tensor(img[None]), torch.tensor(mi[None]), (H, W), max_shear
    ).numpy()[0]
    ref = np.asarray(
        jwarp.warp_affine_twopass(
            jnp.asarray(img), jnp.asarray(mi), (H, W), max_shear
        )
    )
    np.testing.assert_allclose(out, ref, atol=5e-3, rtol=0)
    assert twarp.shift_kmax(H, max_shear) == jwarp.shift_kmax(H, max_shear)
    kmax = twarp.shift_kmax(W, max_shear)
    assert twarp.ext_size(W, kmax) == jwarp.ext_size(W, kmax)


def test_oneshot_matches_jax(batch):
    images, mis = batch
    out = twarp.warp_affine_oneshot(
        torch.tensor(images), torch.tensor(mis), (H, W)
    ).numpy()
    ref = np.asarray(
        jax.vmap(lambda im, mi: jwarp.warp_affine_oneshot(im, mi, (H, W)))(
            jnp.asarray(images), jnp.asarray(mis)
        )
    )
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("kw", CASES[:5])
def test_linear_gradient_interior_truth(kw):
    """Bilinear-class resampling reproduces a linear image exactly, so the
    interior must match the analytic composite for any affine."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = (xx + 2 * yy)[None, ..., None]
    mi = _minv(**kw)
    out = warp_affine_plain(torch.tensor(img), torch.tensor(mi[None]))
    out = out.numpy()[0, ..., 0]
    sx = mi[0, 0] * xx + mi[0, 1] * yy + mi[0, 2]
    sy = mi[1, 0] * xx + mi[1, 1] * yy + mi[1, 2]
    inner = (sx >= 2) & (sx <= W - 3) & (sy >= 2) & (sy <= H - 3)
    assert inner.sum() > 1000
    np.testing.assert_allclose(out[inner], (sx + 2 * sy)[inner], atol=0.02)


@pytest.mark.parametrize("kw", ROTATED)
def test_rotation_differs_from_oneshot(kw):
    """Each pass chains two interpolations (three taps under shear), so a
    rotated two-pass warp is NOT the one-shot warp: on noise they differ by
    far more than the kernel tolerance (5e-3).  A 2-tap-per-pass shortcut
    would collapse onto the one-shot result."""
    img = torch.tensor(_noise()[None])
    mi = torch.tensor(_minv(**kw)[None])
    two = warp_affine_plain(img, mi)
    one = twarp.warp_affine_oneshot(img, mi, (H, W))
    diff = (two - one).abs()
    assert float(diff.max()) > 20.0
    assert float(diff.mean()) > 1.0


@pytest.mark.parametrize("kw", [kw for kw in CASES if not kw.get("theta")])
def test_axis_aligned_matches_oneshot(kw):
    img = torch.tensor(_smooth()[None])
    mi = torch.tensor(_minv(**kw)[None])
    two = warp_affine_plain(img, mi)
    one = twarp.warp_affine_oneshot(img, mi, (H, W))
    np.testing.assert_allclose(two.numpy(), one.numpy(), atol=1e-3)


def test_zero_fill_outside():
    """A big translation leaves the vacated region exactly zero."""
    img = np.random.default_rng(0).uniform(10, 255, (1, H, W, 3))
    mi = _minv(tx=W // 2)
    out = warp_affine_plain(
        torch.tensor(img.astype(np.float32)), torch.tensor(mi[None])
    ).numpy()[0]
    assert np.all(out[:, : W // 2 - 1] == 0.0)
    assert np.all(out[:, W // 2 + 1:] > 0.0)


def test_twopass_coeffs_match_jax():
    """rtol 1e-6, degenerate |d| < 1e-3 maps (the d_safe clamp) included."""
    mis = np.stack(
        [_minv(**kw) for kw in CASES]
        + [np.array([[1, 0.5, 3], [0.2, 5e-4, 1], [0, 0, 1]], np.float32),
           np.array([[1, 0.5, 3], [0.2, -5e-4, 1], [0, 0, 1]], np.float32),
           np.array([[1, 0.5, 3], [0.2, 0.0, 1], [0, 0, 1]], np.float32)]
    )
    got = twarp.twopass_coeffs(torch.tensor(mis), (H, W))
    ref = jax.vmap(lambda m: jnp.stack(jwarp.twopass_coeffs(m, (H, W))))(
        jnp.asarray(mis)
    )
    np.testing.assert_allclose(
        torch.stack(got, -1).numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6
    )


def test_uint8_input_equals_its_f32_copy(batch, plain_out):
    """uint8 images: the wrapper's CPU route gives, bitwise, the plain
    version on ``images.float()`` (the kernel converts in registers, which
    is exact); the output is f32 either way."""
    images, mis = batch
    u8 = torch.tensor(np.round(images).astype(np.uint8))
    got = warp_affine(u8, torch.tensor(mis))
    assert got.dtype == torch.float32
    ref = warp_affine_plain(u8.float(), torch.tensor(mis))
    assert torch.equal(got, ref)
    assert torch.equal(warp_affine(u8.float(), torch.tensor(mis)), ref)


def test_uint8_input_matches_pallas_interpret():
    """Against the TPU kernel on the same uint8 images (interpret mode): it
    casts them to f32 inside and its output back to uint8 (truncation).
    The port's f32 output matches the Pallas kernel on the f32 copy within
    the 5e-3 of ``test_plain_matches_pallas_interpret``, and its truncation
    matches the Pallas uint8 output within one level in fewer than 1e-3 of
    the values (a value at an integer boundary may truncate either way), as
    ``tests/test_torch_augment.py`` holds uint8 images."""
    mis = np.stack([_minv(**kw) for kw in CASES[:6]])
    rng = np.random.default_rng(7)
    u8 = rng.integers(0, 256, (len(mis), H, W, 3), dtype=np.uint8)
    got = warp_affine(torch.tensor(u8), torch.tensor(mis)).numpy()
    ref_f32 = np.asarray(warp_affine_pallas(
        jnp.asarray(u8.astype(np.float32)), jnp.asarray(mis), interpret=True))
    np.testing.assert_allclose(got, ref_f32, atol=5e-3, rtol=0)
    ref_u8 = np.asarray(warp_affine_pallas(
        jnp.asarray(u8), jnp.asarray(mis), interpret=True))
    assert ref_u8.dtype == np.uint8
    diff = np.abs(got.astype(np.uint8).astype(np.int32) - ref_u8.astype(np.int32))
    assert diff.max() <= 1
    assert (diff != 0).mean() < 1e-3


def test_wrapper_rejects_unsupported_inputs(batch):
    """Types the kernel does not read, and images off a 16-byte boundary
    (the kernel reads them in 16-byte pieces), raise on any device."""
    images, mis = batch
    tmis = torch.tensor(mis)
    for dtype in (torch.float64, torch.int32, torch.float16):
        with pytest.raises(TypeError):
            warp_affine(torch.tensor(images).to(dtype), tmis)
    with pytest.raises(TypeError):
        warp_affine(torch.tensor(images), tmis.double())
    flat = torch.zeros(images.size + 1, dtype=torch.uint8)
    shifted = flat[1:].view(images.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="16-byte"):
        warp_affine(shifted, tmis)
