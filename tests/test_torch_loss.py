"""The port's YOLO loss (``odc_tpu_torch.losses.yolo_loss``) against the JAX
package on the CPU: total and the five parts, the per-image and the
paper-style variants, both modes, and the gradient with respect to the head
output."""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from odc_tpu.ops import assign as jassign
from odc_tpu.ops import decode as jdecode
from odc_tpu_torch.ops import assign as tassign
from odc_tpu_torch.ops import decode as tdecode
from torch_port_helpers import calibrated_yolov2, port_model

# The packages' __init__ re-export the function ``yolo_loss`` under the
# module's name, so fetch the modules themselves.
jloss = importlib.import_module("odc_tpu.losses.yolo_loss")
tloss = importlib.import_module("odc_tpu_torch.losses.yolo_loss")

HW = (96, 96)
B, M = 3, 6


def _targets_np():
    """Boxes at 96x96: image 0 holds three boxes (two share a cell), image
    1 none, image 2 one box that overlaps no prediction's cell much."""
    boxes = np.zeros((B, M, 4), np.float32)
    cls_idx = np.random.default_rng(3).integers(0, 20, (B, M)).astype(np.int32)
    valid = np.zeros((B, M), bool)
    boxes[0, 0] = [5, 5, 30, 30]
    boxes[0, 1] = [8, 2, 28, 33]
    boxes[0, 2] = [40, 40, 90, 92]
    valid[0, :3] = True
    boxes[2, 0] = [1, 65, 30, 95]
    valid[2, 0] = True
    return boxes, cls_idx, valid


def _both_targets(mode, hw=HW):
    boxes, cls_idx, valid = _targets_np()
    jt = jassign.assign(
        jnp.asarray(boxes), jnp.asarray(cls_idx), jnp.asarray(valid), hw,
        mode=mode,
    )
    tt = tassign.assign(
        torch.tensor(boxes), torch.tensor(cls_idx), torch.tensor(valid), hw,
        mode=mode,
    )
    return jt, tt


@pytest.fixture(scope="module")
def head():
    """Head output [3, 3, 3, 5, 25] f32 of a bridged, BN-calibrated YOLOv2
    on seeded images, as numpy."""
    images = np.random.default_rng(0).integers(
        0, 255, (B,) + HW + (3,), dtype=np.uint8
    )
    _, variables = calibrated_yolov2(images)
    model = port_model(variables)
    with torch.no_grad():
        return model(torch.tensor(images)).numpy(), model.anchors


def _v1_detections(seed=5):
    """A v1-shaped decoded batch (conf [B, Hg, Wg, A], per-cell class
    probabilities) from the JAX package's ``decode_v1``, in both packages'
    ``Detections``."""
    a = 2
    y = np.random.default_rng(seed).normal(size=(B, 3, 3, a * 5 + 20))
    jdet = jdecode.decode_v1(jnp.asarray(y.astype(np.float32)), HW, a)
    tdet = tdecode.Detections(*(torch.tensor(np.asarray(t)) for t in jdet))
    return jdet, tdet


def _close(got, ref, rtol=1e-5):
    np.testing.assert_allclose(
        got.detach().numpy(), np.asarray(ref), rtol=rtol, atol=1e-7
    )


def test_loss_v2_total_and_parts(head):
    y, anchors = head
    jt, tt = _both_targets("v2")
    ref_total, ref_parts = jloss.yolo_loss(
        jdecode.decode_v2(jnp.asarray(y), HW, anchors), jt,
        jloss.Lambdas(), mode="v2", anchors=anchors,
    )
    total, parts = tloss.yolo_loss(
        tdecode.decode_v2(torch.tensor(y), HW, anchors), tt,
        tloss.Lambdas(), mode="v2", anchors=anchors,
    )
    _close(total, ref_total)
    for name in tloss.LossParts._fields:
        _close(getattr(parts, name), getattr(ref_parts, name))
    assert float(total) > 0


def test_loss_v1_total_and_parts():
    jdet, tdet = _v1_detections()
    jt, tt = _both_targets("v1")
    lam = dict(lambda_xy=2.0, lambda_wh=3.0, lambda_conf=0.7,
               lambda_noobj=0.3, lambda_cls=1.5)
    ref_total, ref_parts = jloss.yolo_loss(
        jdet, jt, jloss.Lambdas(**lam), mode="v1"
    )
    total, parts = tloss.yolo_loss(tdet, tt, tloss.Lambdas(**lam), mode="v1")
    _close(total, ref_total)
    for name in tloss.LossParts._fields:
        _close(getattr(parts, name), getattr(ref_parts, name))


@pytest.mark.parametrize("mode", ["v1", "v2"])
def test_loss_per_image(head, mode):
    y, anchors = head
    jt, tt = _both_targets(mode)
    if mode == "v2":
        jdet = jdecode.decode_v2(jnp.asarray(y), HW, anchors)
        tdet = tdecode.decode_v2(torch.tensor(y), HW, anchors)
    else:
        jdet, tdet = _v1_detections()
        anchors = None
    ref, ref_has = jloss.yolo_loss_per_image(
        jdet, jt, jloss.Lambdas(), mode=mode, anchors=anchors
    )
    got, has = tloss.yolo_loss_per_image(
        tdet, tt, tloss.Lambdas(), mode=mode, anchors=anchors
    )
    np.testing.assert_array_equal(has.numpy(), np.asarray(ref_has))
    assert has.tolist() == [True, False, True] and float(got[1]) == 0.0
    _close(got, ref)


def test_loss_paper():
    jdet, tdet = _v1_detections(seed=6)
    jt, tt = _both_targets("v1")
    ref_total, ref_parts = jloss.yolo_loss_paper(jdet, jt, 4.0, 0.25)
    total, parts = tloss.yolo_loss_paper(tdet, tt, 4.0, 0.25)
    _close(total, ref_total)
    for name in tloss.LossParts._fields:
        _close(getattr(parts, name), getattr(ref_parts, name))


def test_loss_gradient_wrt_head(head):
    """d loss / d head against ``jax.grad``, rtol 1e-4, atol 1e-6 (the
    responsible-anchor IoU is detached in both)."""
    y, anchors = head
    jt, tt = _both_targets("v2")

    def jfn(yy):
        det = jdecode.decode_v2(yy, HW, anchors)
        return jloss.yolo_loss(det, jt, jloss.Lambdas(), "v2", anchors)[0]

    ref = np.asarray(jax.grad(jfn)(jnp.asarray(y)))
    yt = torch.tensor(y, requires_grad=True)
    total, _ = tloss.yolo_loss(
        tdecode.decode_v2(yt, HW, anchors), tt, tloss.Lambdas(), "v2", anchors
    )
    total.backward()
    assert np.abs(ref).max() > 1e-3
    np.testing.assert_allclose(yt.grad.numpy(), ref, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("mode", ["v1", "v2"])
def test_loss_empty_batch_is_zero(head, mode):
    y, anchors = head
    if mode == "v2":
        yt = torch.tensor(y, requires_grad=True)
        det = tdecode.decode_v2(yt, HW, anchors)
    else:
        det, anchors = _v1_detections()[1], None
    z = torch.zeros(B, M, 4)
    tt = tassign.assign(z, z[..., 0].int(), z[..., 0].bool(), HW, mode=mode)
    total, parts = tloss.yolo_loss(det, tt, mode=mode, anchors=anchors)
    assert float(total.detach()) == 0.0
    assert all(float(p.detach()) == 0.0 for p in parts)
    if mode == "v2":  # and the gradient is finite (zero), not NaN
        total.backward()
        assert bool(torch.isfinite(yt.grad).all())


def test_loss_v2_requires_anchors(head):
    y, anchors = head
    _, tt = _both_targets("v2")
    with pytest.raises(ValueError):
        tloss.yolo_loss(tdecode.decode_v2(torch.tensor(y), HW, anchors), tt)
