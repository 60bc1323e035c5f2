"""The port's reference-layout loaders (``odc_tpu_torch.models.convert_torch``)
against the JAX package's (``odc_tpu.models.convert_torch``) on the CPU.

The reference layouts are built here with random weights (nothing is
downloaded): Darknet-19 as ``net1``..``net7`` ``Sequential``s of
``Conv2d``, ``BatchNorm2d``, ``LeakyReLU`` and ``MaxPool2d`` (pools after
stages 1-4 and before stage 6, as the port's backbone pools before stages
2-6), YOLOv2 as ``backbone_model`` + ``head_model``, and YOLOv1 as
``tests/torch_googlenet_replica.py`` under ``backbone_model.backbone_model``
+ a ``head_model`` of ``Flatten``, ``Linear``, ``ReLU``, ``Dropout``,
``Linear`` (the reference's, as ``tests/test_e2e_parity.py`` builds it).
The Darknet-19 weights are a port YOLOv2's, BN calibrated on eight images
so that 64x64 activations keep their scale, then perturbed (BN affine,
running statistics).

Each layout is converted both ways: by the JAX loader into flax variables,
then through ``convert_jax`` into a state dict, and by the port's loader
into a port model.  The state dicts are equal bit for bit, and the f32
forwards at 64x64 agree within the forward tolerance of
``tests/test_torch_yolov2.py``, ``rtol 1e-3, atol 2e-3``, with the
reference convs carrying biases and without.

The flax trees the JAX loaders fill start from the bridged tree of a port
model.  Every leaf of them is overwritten except the conv biases of a
reference without biases, which the JAX loader leaves as the tree holds
them: for YOLOv2 those are set to zeros first, as ``flax.linen.Conv``
initialises a bias (a jitted YOLOv2 init would cost about 6 s here for the
same zeros)."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn as nn

from odc_tpu.models import convert_torch as jconvert
from odc_tpu.models.yolov1 import YOLOv1 as JaxYOLOv1
from odc_tpu.models.yolov2 import YOLOv2 as JaxYOLOv2
from odc_tpu_torch.models import convert_torch as tconvert
from odc_tpu_torch.models.backbones.darknet19 import Darknet19Backbone
from odc_tpu_torch.models.convert_jax import (
    jax_from_state_dict, state_dict_from_jax,
)
from odc_tpu_torch.models.yolov1 import YOLOv1
from torch_googlenet_replica import GoogLeNetReplica, randomize
from torch_port_helpers import calibrate_bn, fresh_yolov2

RTOL, ATOL = 1e-3, 2e-3
HW = (64, 64)
V1_KW = dict(num_grid_cell_in_height=2, num_grid_cell_in_width=2,
             image_size=HW, dropout_rate=0.0)


def _images(n=8, seed=0):
    return np.random.default_rng(seed).integers(0, 255, (n, *HW, 3), np.uint8)


def _seq_of(blocks, pool_before=False, pool_after=False):
    """A reference stage: (conv, bn, leaky) per block, pools around."""
    layers = [nn.MaxPool2d(2, 2)] if pool_before else []
    for conv, bn in blocks:
        layers += [conv, bn, nn.LeakyReLU(0.1)]
    if pool_after:
        layers.append(nn.MaxPool2d(2, 2))
    return nn.Sequential(*layers)


def _reference_block(block, bias: bool, gen):
    """A reference (Conv2d, BatchNorm2d) holding a port ``ConvBnLeaky``'s
    weights, the BN perturbed."""
    w = block.conv.weight
    # skip_init: the weights are overwritten (a default init of the 50 M
    # Darknet-19 weights takes a second).
    conv = torch.nn.utils.skip_init(nn.Conv2d, w.shape[1], w.shape[0],
                                    w.shape[2], padding=w.shape[2] // 2,
                                    bias=bias)
    bn = nn.BatchNorm2d(w.shape[0])
    c = w.shape[0]
    with torch.no_grad():
        conv.weight.copy_(w)
        if bias:
            conv.bias.copy_(block.conv.bias)
        bn.weight.copy_(1 + 0.1 * torch.randn(c, generator=gen))
        bn.bias.copy_(0.1 * torch.randn(c, generator=gen))
        bn.running_mean.copy_(block.bn.running_mean
                              + 0.05 * torch.randn(c, generator=gen))
        bn.running_var.copy_(block.bn.running_var
                             * (0.8 + 0.4 * torch.rand(c, generator=gen)))
    return conv, bn


@functools.lru_cache(maxsize=None)
def _calibrated_port_yolov2():
    model = fresh_yolov2().eval()
    calibrate_bn(model, _images())
    return model


def reference_yolov2(bias: bool, seed: int = 0) -> nn.Module:
    """A reference-layout YOLOv2 (``backbone_model.net1..net7``,
    ``head_model``), its convs with or without biases."""
    src = _calibrated_port_yolov2()
    gen = torch.Generator().manual_seed(seed)
    backbone = nn.Module()
    for k, stage in enumerate(src.backbone.stages, start=1):
        blocks = [_reference_block(b, bias, gen) for b in stage]
        setattr(backbone, f"net{k}",
                _seq_of(blocks, pool_before=k == 6, pool_after=k <= 4))
    conv, bn = _reference_block(src.neck, bias, gen)
    final = torch.nn.utils.skip_init(nn.Conv2d, 1024, 125, 1, bias=bias)
    with torch.no_grad():
        final.weight.copy_(src.head.weight)
        if bias:
            final.bias.copy_(src.head.bias)
    ref = nn.Module()
    ref.backbone_model = backbone
    ref.head_model = nn.Sequential(conv, bn, nn.LeakyReLU(0.1), final)
    return ref


def _jax_yolov2_tree():
    """A YOLOv2 flax tree as a flax init leaves it for the loader: conv
    biases zero."""
    tree = jax_from_state_dict(fresh_yolov2().state_dict())

    def zero_biases(t):
        for k, v in t.items():
            if isinstance(v, dict):
                if "kernel" in v and "bias" in v:
                    v["bias"] = np.zeros_like(v["bias"])
                zero_biases(v)

    zero_biases(tree["params"])
    return tree


@functools.lru_cache(maxsize=None)
def _jax_forward(model):
    return jax.jit(lambda v, x: model.apply(v, x, train=False))


def _assert_bitwise(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name


@pytest.fixture(scope="module", params=[True, False], ids=["bias", "no-bias"])
def converted_v2(request):
    ref = reference_yolov2(request.param)
    port = tconvert.load_torch_yolov2(ref, fresh_yolov2()).eval()
    jvars = jconvert.load_torch_yolov2(ref, _jax_yolov2_tree())
    return dict(ref=ref, port=port, jvars=jvars, bias=request.param)


def test_yolov2_state_is_bitwise_the_jax_conversion(converted_v2):
    """Every parameter and BN statistic, the zero biases of a bias-less
    reference included."""
    _assert_bitwise(converted_v2["port"].state_dict(),
                    state_dict_from_jax(converted_v2["jvars"]))
    if not converted_v2["bias"]:
        assert not converted_v2["port"].neck.conv.bias.any()
        assert not converted_v2["port"].head.bias.any()


def test_yolov2_forward_matches_jax(converted_v2):
    images = _images(2, seed=1)
    with torch.no_grad():
        got = converted_v2["port"](torch.from_numpy(images)).numpy()
    want = np.asarray(_jax_forward(JaxYOLOv2(image_size=HW))(
        jax.tree.map(jnp.asarray, converted_v2["jvars"]),
        jnp.asarray(images)))
    assert np.abs(want).max() > 1.0  # the calibrated network keeps scale
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_darknet19_alone_is_bitwise_the_jax_conversion(converted_v2):
    """``load_torch_darknet19`` into a bare ``Darknet19Backbone``: its
    state is the backbone part of the JAX package's conversion."""
    backbone_model = converted_v2["ref"].backbone_model
    backbone = fresh_yolov2().backbone  # a Darknet19Backbone
    assert isinstance(backbone, Darknet19Backbone)
    port = tconvert.load_torch_darknet19(backbone_model, backbone)
    jvars = jconvert.load_torch_darknet19(backbone_model, _jax_yolov2_tree())
    want = {k[len("backbone."):]: v
            for k, v in state_dict_from_jax(jvars).items()
            if k.startswith("backbone.")}
    _assert_bitwise(port.state_dict(), want)


def test_unpaired_conv_bn_raises():
    ref = reference_yolov2(True)
    ref.backbone_model.net3 = nn.Sequential(*list(ref.backbone_model.net3)[1:])
    with pytest.raises(ValueError, match="unpaired conv/bn"):
        tconvert.load_torch_yolov2(ref, fresh_yolov2())
    with pytest.raises(ValueError, match="unpaired conv/bn"):
        jconvert.load_torch_yolov2(ref, _jax_yolov2_tree())


def reference_yolov1(seed: int = 1) -> nn.Module:
    """A reference-layout YOLOv1 at 64x64 (grid 2): the GoogLeNet replica
    (random weights and BN statistics) and the reference head."""
    backbone = nn.Module()
    backbone.backbone_model = randomize(GoogLeNetReplica(), seed=seed)
    torch.manual_seed(seed)
    ref = nn.Module()
    ref.backbone_model = backbone
    ref.head_model = nn.Sequential(
        nn.Flatten(), nn.Linear(2 * 2 * 1024, 4096), nn.ReLU(),
        nn.Dropout(0.5), nn.Linear(4096, 2 * 2 * 30))
    return ref


@pytest.fixture(scope="module")
def converted_v1():
    ref = reference_yolov1()
    start = YOLOv1(**V1_KW, device="cpu", seed=5)
    jvars = jconvert.load_torch_yolov1(
        ref, jax_from_state_dict(start.state_dict()))
    port = tconvert.load_torch_yolov1(ref, start).eval()
    return dict(ref=ref, port=port, jvars=jvars)


def test_yolov1_state_is_bitwise_the_jax_conversion(converted_v1):
    _assert_bitwise(converted_v1["port"].state_dict(),
                    state_dict_from_jax(converted_v1["jvars"]))


def test_yolov1_forward_matches_jax(converted_v1):
    images = _images(2, seed=3)
    with torch.no_grad():
        got = converted_v1["port"](torch.from_numpy(images)).numpy()
    want = np.asarray(_jax_forward(JaxYOLOv1(**V1_KW))(
        jax.tree.map(jnp.asarray, converted_v1["jvars"]),
        jnp.asarray(images)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_googlenet_alone_and_shape_checks():
    """``load_torch_googlenet_backbone`` into the model's backbone equals
    the YOLOv1 loader's; a reference head of the wrong width raises."""
    ref = reference_yolov1(seed=2)
    model = YOLOv1(**V1_KW, device="cpu")
    tconvert.load_torch_googlenet_backbone(ref.backbone_model.backbone_model,
                                           model)
    want = tconvert.load_torch_yolov1(ref, YOLOv1(**V1_KW, device="cpu"))
    _assert_bitwise(model.backbone.state_dict(), want.backbone.state_dict())
    ref.head_model[-1] = nn.Linear(4096, 7 * 7 * 30)
    with pytest.raises(ValueError, match="head Linear weight"):
        tconvert.load_torch_yolov1(ref, model)
