"""Reference-layout torch checkpoints -> the port's models.

Counterpart of ``odc_tpu/models/convert_torch.py``: lets a user of the
reference framework carry its torch modules' weights into the port.  Both
sides are PyTorch, so this is a copy between two module layouts, with no
flax tree in between:

* the reference keeps Darknet-19 in seven ``Sequential``s ``net1``..``net7``
  of ``Conv2d``, ``BatchNorm2d``, activations and pools, in order, and
  YOLOv2's neck conv and head in ``head_model``; the port keeps
  ``ConvBnLeaky`` blocks (``conv``, ``bn``) in ``backbone.stages`` and
  ``neck``/``head``;
* YOLOv1's GoogLeNet is torchvision's layout on both sides
  (``models/backbones/convert_googlenet.py``), and its ``head_model``'s
  ``Linear`` layers go into ``fc1`` and ``fc2`` (the flatten order is NHWC
  row-major on both sides).

Weights keep PyTorch's layouts (``Conv2d`` [out, in, kh, kw], ``Linear``
[out, in]).  The walk pairs each ``Conv2d`` with the ``BatchNorm2d`` in the
same position, ignoring pools and activations, and raises on an unpaired
one.  A reference conv without a bias writes zeros into the port's conv
bias, which the port always carries: flax initialises that bias to zero and
the JAX loader leaves it, so both packages compute the same function from
one checkpoint.  Every copy checks shapes.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn

from odc_tpu_torch.models.backbones.convert_googlenet import (
    load_torch_googlenet,
)
from odc_tpu_torch.models.backbones.darknet19 import Darknet19Backbone
from odc_tpu_torch.models.backbones.googlenet import GoogLeNetBackbone
from odc_tpu_torch.models.layers import ConvBnLeaky


def _conv_bn_pairs(seq) -> List[Tuple[nn.Conv2d, nn.BatchNorm2d]]:
    """(Conv2d, BatchNorm2d) pairs from a torch Sequential, in order."""
    convs = [m for m in seq if isinstance(m, nn.Conv2d)]
    bns = [m for m in seq if isinstance(m, nn.BatchNorm2d)]
    if len(convs) != len(bns):
        raise ValueError(
            f"unpaired conv/bn in sequential: {len(convs)} vs {len(bns)}"
        )
    return list(zip(convs, bns))


@torch.no_grad()
def _copy(dst: torch.Tensor, src, what: str) -> None:
    """``dst[...] = src`` (zeros for a ``src`` of None), shapes equal."""
    if src is None:
        dst.zero_()
        return
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{what}: reference shape {tuple(src.shape)} != "
                         f"the port's {tuple(dst.shape)}")
    dst.copy_(src.detach())


def _fill_block(block: ConvBnLeaky, conv: nn.Conv2d, bn: nn.BatchNorm2d,
                what: str) -> None:
    """One reference (Conv2d, BatchNorm2d) into a ``ConvBnLeaky``."""
    _copy(block.conv.weight, conv.weight, f"{what} conv weight")
    _copy(block.conv.bias, conv.bias, f"{what} conv bias")
    _copy(block.bn.weight, bn.weight, f"{what} bn weight")
    _copy(block.bn.bias, bn.bias, f"{what} bn bias")
    _copy(block.bn.running_mean, bn.running_mean, f"{what} bn mean")
    _copy(block.bn.running_var, bn.running_var, f"{what} bn var")


def _part(module: nn.Module, cls):
    """``module`` itself when it is a ``cls``, else its ``backbone``."""
    if isinstance(module, cls):
        return module
    backbone = getattr(module, "backbone", None)
    if isinstance(backbone, cls):
        return backbone
    raise TypeError(f"{type(module).__name__} is neither a {cls.__name__} "
                    f"nor a model holding one as .backbone")


def load_torch_darknet19(torch_backbone, module: nn.Module) -> nn.Module:
    """Copy a reference Darknet-19 (a torch module with ``net1``..``net7``
    ``Sequential``s) into the port's ``Darknet19Backbone`` ``module``, or
    into the one a model holds as ``backbone``.  Returns ``module``."""
    backbone = _part(module, Darknet19Backbone)
    for k, stage in enumerate(backbone.stages, start=1):
        pairs = _conv_bn_pairs(getattr(torch_backbone, f"net{k}"))
        if len(pairs) != len(stage):
            raise ValueError(f"net{k}: {len(pairs)} conv/bn pairs, the "
                             f"port's stage {k} has {len(stage)} blocks")
        for i, (conv, bn) in enumerate(pairs):
            _fill_block(stage[i], conv, bn, f"net{k} pair {i}")
    return module


def load_torch_googlenet_backbone(torch_googlenet,
                                  module: nn.Module) -> nn.Module:
    """Copy a torchvision-layout GoogLeNet (``conv1``..``inception5b``, the
    part the reference walks) into the port's ``GoogLeNetBackbone``
    ``module``, or into the one a model holds as ``backbone``.  Returns
    ``module``."""
    load_torch_googlenet(_part(module, GoogLeNetBackbone),
                         torch_googlenet.state_dict())
    return module


def load_torch_yolov1(torch_model, model: nn.Module) -> nn.Module:
    """Copy a reference YOLOv1 (GoogLeNet as
    ``backbone_model.backbone_model``, then a ``head_model`` of two
    ``Linear`` layers among its flatten, activation and dropout) into the
    port's ``YOLOv1`` ``model``.  Returns ``model``."""
    load_torch_googlenet_backbone(
        torch_model.backbone_model.backbone_model, model)
    linears = [m for m in torch_model.head_model if isinstance(m, nn.Linear)]
    if len(linears) != 2:
        raise ValueError(f"head_model holds {len(linears)} Linear layers, "
                         "the port's YOLOv1 two (fc1, fc2)")
    for fc, lin in zip((model.fc1, model.fc2), linears):
        _copy(fc.weight, lin.weight, "head Linear weight")
        _copy(fc.bias, lin.bias, "head Linear bias")
    return model


def load_torch_yolov2(torch_model, model: nn.Module) -> nn.Module:
    """Copy a reference YOLOv2 (Darknet-19 as ``backbone_model``, then a
    ``head_model`` of the 3x3 neck conv, its BatchNorm and activation and
    the final 1x1 conv) into the port's ``YOLOv2`` ``model``.  Returns
    ``model``."""
    load_torch_darknet19(torch_model.backbone_model, model)
    head = torch_model.head_model
    convs = [m for m in head if isinstance(m, nn.Conv2d)]
    bn = next(m for m in head if isinstance(m, nn.BatchNorm2d))
    _fill_block(model.neck, convs[0], bn, "head_model neck")
    _copy(model.head.weight, convs[-1].weight, "head conv weight")
    _copy(model.head.bias, convs[-1].bias, "head conv bias")
    return model
