"""The port's int8 engine with ``valid_hw`` (the masked native-size forward)
against ``odc_tpu.ops.int8_engine`` on the CPU: the code mask and the
native border correction (the port's ``_zp_border_correction`` with
extents, JAX's ``_zp_border_correction_native``) bit for bit, the masked engine's neck-input codes
bit for bit against the EAGER JAX engine (one run; see
``tests/test_torch_int8_engine.py`` for why never a jitted one), and the
refusals.  The port's own claim that a masked bucket gives each image its
native-size codes is tested in ``tests/test_torch_native.py``.

Weights: the port's seeded YOLOv2 with BN calibrated on the images of
``torch_port_helpers.int8_parity_setup``; scales from the port's
``calibrate`` on those images, fed to both engines.  The bucket is 96 x 128
and holds one of those images (64 x 96), a bucket-filling image (which runs
the ``eh == H`` / ``ew == W`` border terms) and an odd-sized one."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from odc_tpu.ops import int8_engine as je
from odc_tpu_torch.ops import int8_engine as te
from torch_port_helpers import int8_parity_setup, pad_to_bucket, port_model

BUCKET = (96, 128)


@functools.lru_cache(maxsize=1)
def _setup():
    images, _jmodel, variables = int8_parity_setup()
    rng = np.random.default_rng(21)
    natives = [images[0],
               rng.integers(0, 255, (*BUCKET, 3), dtype=np.uint8),
               rng.integers(0, 255, (77, 101, 3), dtype=np.uint8)]
    imgs, vhw = pad_to_bucket(natives, BUCKET)
    model = port_model(variables)
    scales = te.calibrate(model, torch.tensor(images)).numpy()
    return dict(natives=natives, imgs=imgs, vhw=vhw, model=model,
                variables=variables, scales=scales)


@pytest.fixture(scope="module")
def setup():
    return _setup()


def _port(setup, images, **kw):
    return te.yolov2_int8_forward(setup["model"], torch.tensor(images),
                                  scales=setup["scales"], **kw)


@pytest.mark.parametrize("z", [None, -93.4, 17.0])
def test_mask_codes_matches_jax(z):
    rng = np.random.default_rng(4)
    eh, ew = np.array([5, 2, 7]), np.array([9, 9, 0])
    q = rng.integers(-128, 128, (3, 7, 9, 4), dtype=np.int8)
    x = rng.standard_normal((3, 7, 9, 4)).astype(np.float32)
    for h in (q, x):
        zz = None if z is None else np.float32(z)
        ref = np.asarray(je._mask_codes(
            jnp.asarray(h), jnp.asarray(eh, jnp.int32),
            jnp.asarray(ew, jnp.int32), None if zz is None else jnp.asarray(zz)))
        got = te._mask_codes(torch.tensor(h), torch.tensor(eh),
                             torch.tensor(ew),
                             None if zz is None else torch.tensor(zz))
        assert got.dtype == torch.tensor(h).dtype
        np.testing.assert_array_equal(got.numpy(), ref)


def test_zp_border_correction_native_matches_jax():
    """Bit for bit, at extents that fill the bucket in one dimension, in
    both, and in neither."""
    rng = np.random.default_rng(5)
    wq = rng.integers(-127, 128, (3, 3, 16, 8), dtype=np.int8)
    hw = (6, 10)
    eh, ew = np.array([6, 3, 6, 1]), np.array([10, 10, 4, 7])
    z = np.float32(-57.0)
    ref = np.asarray(je._zp_border_correction_native(
        jnp.asarray(wq), jnp.asarray(z), hw, jnp.asarray(eh, jnp.int32),
        jnp.asarray(ew, jnp.int32)))
    got = te._zp_border_correction(
        torch.tensor(wq), torch.tensor(z), hw, torch.tensor(eh),
        torch.tensor(ew))
    assert got.shape == ref.shape == (4, 6, 10, 8)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_masked_codes_match_eager_jax(setup):
    """Neck-input codes (``stop_after=21``) of the masked bucket, s2d stem,
    bit for bit against the eager JAX engine given the same weights,
    images, extents and scales (every cell, junk included)."""
    jv = jax.tree.map(jnp.asarray, setup["variables"])
    ref = np.asarray(je.yolov2_int8_forward(
        jv, jnp.asarray(setup["imgs"]), scales=jnp.asarray(setup["scales"]),
        stem="s2d", valid_hw=jnp.asarray(setup["vhw"]), stop_after=21))
    got = _port(setup, setup["imgs"], stem="s2d", valid_hw=setup["vhw"],
                stop_after=21).numpy()
    assert got.dtype == ref.dtype == np.int8 and got.shape == (3, 3, 4, 3072)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kw, match", [
    (dict(stem="s2d2"), "stem='plain'/'s2d'"),
    (dict(stem="plain", bf16_front=1), "bf16_front=0"),
    (dict(scales=None), "engine-mode only"),
])
def test_valid_hw_refusals(setup, kw, match):
    """As in JAX: ``valid_hw`` takes only the shipped configurations, in
    engine mode."""
    kw = dict(dict(scales=setup["scales"]), **kw)
    with pytest.raises(ValueError, match=match):
        te.yolov2_int8_forward(setup["model"], torch.tensor(setup["imgs"]),
                               valid_hw=setup["vhw"], **kw)
