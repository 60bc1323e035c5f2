"""The port's GoogLeNet (``odc_tpu_torch/models/backbones/googlenet.py``,
``convert_googlenet.py``) on the CPU, f32: the two NHWC pools bit for bit
against flax's, and the torchvision-layout replica loaded through
``load_torch_googlenet``.  The backbone against JAX ``GoogLeNetBackbone``
is held in ``test_torch_yolov1.py``, inside the YOLOv1 forward."""

import numpy as np
import pytest

import flax.linen as fnn
import jax.numpy as jnp
import torch

from odc_tpu.models import layers as jlayers
from odc_tpu_torch.models import layers as tlayers
from odc_tpu_torch.models.backbones.convert_googlenet import (
    load_torch_googlenet,
)
from odc_tpu_torch.models.backbones.googlenet import GoogLeNetBackbone
from odc_tpu_torch.models.layers import imagenet_normalize
from odc_tpu_torch.models.yolov1 import backbone_hw
from torch_googlenet_replica import GoogLeNetReplica, randomize


@pytest.mark.parametrize("size", [7, 8, 15, 16])
def test_pools_equal_flax(size):
    """Both NHWC pools, bit for bit, at even and odd sizes (an odd side
    gives the ceil-mode pool a window over the -inf padding)."""
    rng = np.random.default_rng(size)
    x = rng.normal(size=(2, size, size + 1, 5)).astype(np.float32)
    ceil = tlayers.max_pool_3x3_ceil(torch.tensor(x)).numpy()
    ref = np.asarray(jlayers.max_pool_3x3_ceil(jnp.asarray(x)))
    assert ceil.shape == ref.shape == (2, size // 2, (size + 1) // 2, 5)
    np.testing.assert_array_equal(ceil, ref)
    same = tlayers.max_pool_same(torch.tensor(x), 3).numpy()
    ref = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), (1, 1), "SAME"))
    np.testing.assert_array_equal(same, ref)


def _replica_forward(net, x):
    """The reference's manual layer walk over a torchvision GoogLeNet
    (conv1 .. inception5b, no avgpool or fc), NCHW float in."""
    h = net.maxpool1(net.conv1(x))
    h = net.maxpool2(net.conv3(net.conv2(h)))
    h = net.maxpool3(net.inception3b(net.inception3a(h)))
    for name in ("4a", "4b", "4c", "4d", "4e"):
        h = getattr(net, f"inception{name}")(h)
    h = net.maxpool4(h)
    return net.inception5b(net.inception5a(h))


@pytest.mark.parametrize("hw", [(64, 64), (96, 80)])
def test_backbone_matches_torchvision_replica(hw):
    """A torchvision-layout state_dict (random weights and running
    statistics, ``num_batches_tracked`` and an ``fc`` included) loads
    strictly and computes the replica's function within 1e-5."""
    replica = randomize(GoogLeNetReplica(), seed=2)
    sd = dict(replica.state_dict())
    assert any(k.endswith("num_batches_tracked") for k in sd)
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, 1024), torch.zeros(1000)
    ours = load_torch_googlenet(GoogLeNetBackbone(), sd).eval()
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.integers(0, 255, (2, *hw, 3), dtype=np.uint8))
    with torch.no_grad():
        got = ours(x).numpy()
        ref = _replica_forward(
            replica, imagenet_normalize(x).permute(0, 3, 1, 2)
        ).permute(0, 2, 3, 1).numpy()
    assert got.shape == (2, *backbone_hw(hw), 1024)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)

    sd["inception4a.branch2.1.conv.weight"] = sd[
        "inception4a.branch2.1.conv.weight"][:, :, :1]
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_torch_googlenet(GoogLeNetBackbone(), sd)
    del sd["inception4a.branch2.1.conv.weight"]
    with pytest.raises(RuntimeError, match="Missing key"):
        load_torch_googlenet(GoogLeNetBackbone(), sd)


def test_loads_a_pth_file(tmp_path):
    replica = randomize(GoogLeNetReplica(), seed=4)
    path = str(tmp_path / "googlenet.pth")
    torch.save(replica.state_dict(), path)
    ours = load_torch_googlenet(GoogLeNetBackbone(), path)
    assert torch.equal(ours.inception5b.branch4[1].conv.weight,
                       replica.inception5b.branch4[1].conv.weight)
    assert torch.equal(ours.conv1.bn.running_var,
                       replica.conv1.bn.running_var)
