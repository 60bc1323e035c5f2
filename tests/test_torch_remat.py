"""``remat`` on the port's YOLOv2 and Darknet-19
(``odc_tpu_torch.models.layers.rematerialize``) on the CPU at 64x64.

* Against the JAX package: the port's ``YOLOv2(remat=True)`` in training
  mode (batch statistics, gradients on, so the stages run under
  ``torch.utils.checkpoint``) against JAX ``YOLOv2(remat=True).apply(...,
  train=True)`` on bridged weights: the heads within the forward tolerance
  of ``tests/test_torch_yolov2.py``, ``rtol 1e-3, atol 2e-3``, and the new
  running statistics within the same.
* Against itself, in float64: with and without remat, the outputs and
  every gradient within 1e-12 relative (the recomputation repeats the same
  operations), and the running statistics after one forward and backward
  bit for bit equal: a recomputation that moved them a second time would
  leave them off by a decay step.  The one-rank gloo group's version is in
  ``tests/test_torch_parallel.py``.
"""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from odc_tpu.models.yolov2 import YOLOv2 as JaxYOLOv2
from odc_tpu_torch.models.convert_jax import jax_from_state_dict
from odc_tpu_torch.models.layers import TorchBatchNorm
from odc_tpu_torch.models.yolov2 import YOLOv2
from torch_port_helpers import fresh_yolov2

RTOL, ATOL = 1e-3, 2e-3
HW = (64, 64)


def _images(n=4, seed=0):
    return np.random.default_rng(seed).integers(0, 255, (n, *HW, 3), np.uint8)


def _with_remat(model):
    """A copy of ``model`` with ``remat`` on (what the constructor's
    argument sets: test_remat_parameters_and_names_are_unchanged)."""
    model = copy.deepcopy(model)
    model.backbone.remat = True
    return model


def test_remat_parameters_and_names_are_unchanged():
    with_remat = YOLOv2(device="cpu", remat=True)
    plain = fresh_yolov2()
    assert with_remat.backbone.remat and not plain.backbone.remat
    sd, ref = with_remat.state_dict(), plain.state_dict()
    assert list(sd) == list(ref)
    assert all(torch.equal(sd[k], ref[k]) for k in ref)


def test_train_forward_matches_jax_remat():
    model = _with_remat(fresh_yolov2())
    variables = jax_from_state_dict(model.state_dict())
    images = _images(2)
    model.train()
    y = model(torch.from_numpy(images))
    assert y.requires_grad  # the checkpointed path ran
    jy, new = jax.jit(lambda v, x: JaxYOLOv2(image_size=HW, remat=True).apply(
        v, x, train=True, mutable=["batch_stats"]))(
            jax.tree.map(jnp.asarray, variables), jnp.asarray(images))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=RTOL, atol=ATOL)
    stats = jax_from_state_dict(model.state_dict())["batch_stats"]
    flat = jax.tree_util.tree_leaves_with_path(new["batch_stats"])
    assert len(flat) == 2 * sum(isinstance(m, TorchBatchNorm)
                                for m in model.modules())
    for path, want in flat:
        got = stats
        for key in path:
            got = got[key.key]
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                   atol=ATOL, err_msg=str(path))


def _fwd_bwd(model, images):
    model.train()
    y = model(torch.from_numpy(images))
    w = torch.linspace(-1, 1, y.numel(), dtype=torch.float64).view_as(y)
    (y * w).sum().backward()
    return model, y.detach()


@pytest.fixture(scope="module")
def both_runs():
    images = _images(2, seed=1)
    plain = YOLOv2(dtype=torch.float64, device="cpu", seed=7).double()
    remat = _with_remat(plain)
    return _fwd_bwd(plain, images), _fwd_bwd(remat, images)


def test_remat_outputs_and_gradients_equal_in_float64(both_runs):
    (plain, y0), (remat, y1) = both_runs
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), rtol=1e-12, atol=0)
    grads = dict(remat.named_parameters())
    for name, p in plain.named_parameters():
        g0, g1 = p.grad, grads[name].grad
        assert g1 is not None, name
        rel = (g1 - g0).norm() / g0.norm().clamp(min=1e-300)
        assert rel <= 1e-12, (name, float(rel))


def test_remat_moves_running_statistics_once(both_runs):
    (plain, _), (remat, _) = both_runs
    bufs = dict(remat.named_buffers())
    moved = 0
    for name, b in plain.named_buffers():
        assert torch.equal(bufs[name], b), name
        moved += not torch.equal(b, torch.zeros_like(b)) and \
            not torch.equal(b, torch.ones_like(b))
    assert moved == len(bufs)  # every statistic took its one step
    assert not any(m.keep_running_stats for m in remat.modules()
                   if isinstance(m, TorchBatchNorm))


def test_remat_is_off_without_gradients_or_in_eval():
    """``torch.no_grad()`` and eval mode run the stages plainly (no
    checkpoint to recompute): the same outputs as without remat."""
    images = torch.from_numpy(_images(2, seed=2))
    plain = fresh_yolov2().eval()
    model = _with_remat(plain)
    with torch.no_grad():
        assert torch.equal(model(images), plain(images))
    model.train()
    plain.train()
    with torch.no_grad():
        assert torch.equal(model(images), plain(images))
