"""The port's YOLOv2 (``odc_tpu_torch.models``) against the JAX package on
the CPU, in f32 at full width and small spatial size: the weight bridge,
the forward pass, and ``decode_v2``."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from odc_tpu.models import yolov2 as jyolov2
from odc_tpu.ops import decode as jdecode
from odc_tpu_torch.models import yolov2 as tyolov2
from odc_tpu_torch.models.convert_jax import (
    jax_from_state_dict, state_dict_from_jax,
)
from odc_tpu_torch.ops import decode as tdecode
from torch_port_helpers import calibrated_yolov2, jax_init, port_model


@pytest.fixture(scope="module")
def shared():
    """(images [2, 96, 96, 3] uint8, JAX model, numpy variables)."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 255, (2, 96, 96, 3), dtype=np.uint8)
    jmodel, variables = calibrated_yolov2(images)
    return images, jmodel, variables


def test_bridge_round_trips_exactly(shared):
    _, jmodel, variables = shared
    fresh = jax_init(jmodel, key=1)
    for tree in (fresh, variables):
        back = jax_from_state_dict(state_dict_from_jax(tree))
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    # The port's own tree has exactly the bridged names and shapes.
    sd = state_dict_from_jax(fresh)
    model = tyolov2.YOLOv2(device="cpu")
    own = model.state_dict()
    assert sorted(own) == sorted(sd)
    assert all(own[k].shape == sd[k].shape for k in sd)


def test_forward_matches_jax(shared):
    """Head output [2, 3, 3, 5, 25] from the same weights, at the tolerance
    of ``tests/test_e2e_parity.py`` (rtol 1e-3, atol 2e-3)."""
    images, jmodel, variables = shared
    ref = np.asarray(
        jmodel.apply(
            jax.tree.map(jnp.asarray, variables), jnp.asarray(images),
            train=False,
        )
    )
    with torch.no_grad():
        got = port_model(variables)(torch.tensor(images)).numpy()
    assert got.shape == ref.shape == (2, 3, 3, 5, 25)
    assert got.dtype == np.float32
    assert ref.std() > 0.3  # calibrated: outputs are not bias-dominated
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=2e-3)


def test_config_matches_jax():
    """The port's own copy of the config keeps the JAX package's keys and
    values (the device layout aside: a mesh there, a device string here)."""
    import dataclasses

    from odc_tpu import config as jconfig
    from odc_tpu_torch import config as tconfig

    assert tconfig.BATCH_SIZE == jconfig.BATCH_SIZE
    for name in ("MODEL_CONFIG", "TRAIN_CONFIG"):
        assert repr(getattr(tconfig, name)) == repr(getattr(jconfig, name))
    for cls in ("ModelConfig", "TrainConfig"):
        tc, jc = getattr(tconfig, cls)(), getattr(jconfig, cls)()
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)


def test_reorgs_match_jax():
    rng = np.random.default_rng(2)
    for shape in ((2, 6, 6, 8), (1, 7, 5, 4)):  # odd dims drop a row/col
        x = rng.normal(size=shape).astype(np.float32)
        for fn in ("quadrant_stack", "space_to_depth"):
            ref = np.asarray(getattr(jyolov2, fn)(jnp.asarray(x)))
            got = getattr(tyolov2, fn)(torch.tensor(x)).numpy()
            np.testing.assert_array_equal(got, ref, err_msg=fn)


def test_decode_v2_matches_jax():
    """Every decoded field within rtol 1e-6; box corners also get an atol
    of 1e-4 px, for x1 = bx - bw/2 cancelling near 0 (where a 1-ulp
    difference in exp is a large relative error)."""
    rng = np.random.default_rng(3)
    y = rng.normal(0, 1.5, (2, 13, 13, 5, 25)).astype(np.float32)
    ref = jdecode.decode_v2(jnp.asarray(y), (416, 416))
    got = tdecode.decode_v2(torch.tensor(y), (416, 416))
    for name in tdecode.Detections._fields:
        atol = 1e-4 if name == "boxes" else 0
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
            rtol=1e-6, atol=atol, err_msg=name,
        )
