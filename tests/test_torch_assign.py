"""The port's target assignment (``odc_tpu_torch.ops.assign``) against the
JAX package on the CPU: bitwise, padded and degenerate rows included."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from odc_tpu.ops import assign as jassign
from odc_tpu_torch.ops import assign as tassign

FIELDS = ("cell", "sig_txty", "twth", "box", "cls", "valid")


def _batch(seed, b, m, hw):
    """Boxes [b, m, 4] with a random number of valid rows per image; the
    padded rows hold zeros, a degenerate (zero-size) box, a box outside the
    canvas and a box with negative corners."""
    rng = np.random.default_rng(seed)
    h, w = hw
    boxes = np.zeros((b, m, 4), np.float32)
    cls_idx = np.zeros((b, m), np.int32)
    valid = np.zeros((b, m), bool)
    for i in range(b):
        n = int(rng.integers(0, m - 2))
        x1 = rng.uniform(0, w - 40, n)
        y1 = rng.uniform(0, h - 40, n)
        bw = rng.uniform(2, 40, n)
        bh = rng.uniform(2, 40, n)
        boxes[i, :n] = np.stack([x1, y1, x1 + bw, y1 + bh], -1)
        cls_idx[i, :n] = rng.integers(0, 20, n)
        valid[i, :n] = True
        boxes[i, m - 3] = [17.25, 33.5, 17.25, 33.5]          # degenerate
        boxes[i, m - 2] = [w + 50, h + 70, w + 90, h + 99]    # off canvas
        boxes[i, m - 1] = [-40.5, -3.25, -1.0, 20.0]          # negative
    return boxes, cls_idx, valid


@pytest.mark.parametrize("mode", ["v1", "v2"])
@pytest.mark.parametrize("hw", [(416, 416), (96, 160), (224, 224)])
def test_assign_bitwise_equal_to_jax(mode, hw):
    boxes, cls_idx, valid = _batch(0, 4, 8, hw)
    ref = jassign.assign(
        jnp.asarray(boxes), jnp.asarray(cls_idx), jnp.asarray(valid), hw,
        mode=mode,
    )
    got = tassign.assign(
        torch.tensor(boxes), torch.tensor(cls_idx), torch.tensor(valid), hw,
        mode=mode,
    )
    for name in FIELDS:
        g, r = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        assert g.dtype == r.dtype and g.shape == r.shape, name
        np.testing.assert_array_equal(g, r, err_msg=name)


@pytest.mark.parametrize("mode", ["v1", "v2", "v3"])
def test_assign_numpy_bitwise_equal_to_jax(mode):
    rng = np.random.default_rng(1)
    hw = (416, 416)
    for n in (0, 1, 5, 12):  # 12 > max_boxes: truncated
        x1 = rng.uniform(0, 370, n)
        y1 = rng.uniform(0, 370, n)
        bl = np.stack(
            [x1, y1, x1 + rng.uniform(2, 40, n), y1 + rng.uniform(2, 40, n)],
            -1,
        )
        cl = rng.integers(0, 20, n)
        ref = jassign.assign_numpy(bl, cl, hw, mode=mode, max_boxes=8)
        got = tassign.assign_numpy(bl, cl, hw, mode=mode, max_boxes=8)
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)


def test_assign_rejects_unknown_mode():
    with pytest.raises(ValueError):
        tassign.assign_numpy([], [], (64, 64), mode="v4")
    z = torch.zeros(1, 1, 4)
    with pytest.raises(ValueError):
        tassign.assign(z, z[..., 0].int(), z[..., 0].bool(), (64, 64), "v0")


def test_densify_equal_to_jax():
    hw = (96, 160)
    boxes, cls_idx, valid = _batch(2, 3, 6, hw)
    jt = jassign.assign(
        jnp.asarray(boxes), jnp.asarray(cls_idx), jnp.asarray(valid), hw
    )
    tt = tassign.assign(
        torch.tensor(boxes), torch.tensor(cls_idx), torch.tensor(valid), hw
    )
    ref = jassign.densify(jt, (3, 5), 20)
    got = tassign.densify(tt, (3, 5), 20)
    assert len(got) == len(ref) == 7
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape
        np.testing.assert_array_equal(g.numpy(), r)
