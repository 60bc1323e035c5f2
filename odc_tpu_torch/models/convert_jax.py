"""JAX (flax) <-> PyTorch weight bridge for YOLOv1 and YOLOv2.

The inverse of ``odc_tpu/models/convert_torch.py``'s layout:

* flax ``kernel`` [kh, kw, in, out] <-> conv ``weight`` [out, in, kh, kw];
* flax Dense ``kernel`` [in, out] <-> ``Linear.weight`` [out, in];
* flax BN ``scale``/``bias`` plus ``batch_stats`` ``mean``/``var`` <->
  ``weight``/``bias``/``running_mean``/``running_var``.

The flax side is a ``variables`` tree already turned into nested dicts of
numpy arrays (``{"params": ..., "batch_stats": ...}``); a whole train state
adds ``momentum`` (same layout as ``params``) and ``step``.  This module
imports neither JAX nor flax.  The model is read off the tree itself
(``GoogLeNetBackbone_0`` or ``fc1.weight`` mean YOLOv1).  Paths:

* YOLOv2: ``Darknet19Backbone_0/stage{k}/ConvBnLeaky_{i}`` (backbone),
  ``ConvBnLeaky_0`` (the 3x3 neck conv), ``Conv_0`` (the head);
* YOLOv1: ``GoogLeNetBackbone_0/BasicConv2d_{0..2}`` (stem convs),
  ``GoogLeNetBackbone_0/Inception_{0..8}/BasicConv2d_{0..5}`` (torchvision
  order, numbered as flax numbers them: by construction, not by name),
  ``Dense_0`` and ``Dense_1``.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from odc_tpu_torch.models.backbones.darknet19 import _STAGES
from odc_tpu_torch.models.backbones.googlenet import (
    _INCEPTIONS, INCEPTION_UNITS,
)


def _blocks(v1: bool) -> Iterator[Tuple[Tuple[str, ...], str]]:
    """(flax path of each conv + BN unit, matching PyTorch module prefix).
    YOLOv1's convs have no bias, YOLOv2's have one."""
    if v1:
        g = "GoogLeNetBackbone_0"
        for i, name in enumerate(("conv1", "conv2", "conv3")):
            yield (g, f"BasicConv2d_{i}"), f"backbone.{name}"
        for i, blk in enumerate(_INCEPTIONS):
            for j, unit in enumerate(INCEPTION_UNITS):
                yield ((g, f"Inception_{i}", f"BasicConv2d_{j}"),
                       f"backbone.inception{blk}.{unit}")
        return
    for k, stage in enumerate(_STAGES):
        for i in range(len(stage)):
            yield (
                ("Darknet19Backbone_0", f"stage{k + 1}", f"ConvBnLeaky_{i}"),
                f"backbone.stages.{k}.{i}",
            )
    yield ("ConvBnLeaky_0",), "neck"


def _heads(v1: bool) -> Iterator[Tuple[str, str]]:
    """(flax name, PyTorch name) of the layers after the last BN: Dense
    layers for v1, the 1x1 conv for v2."""
    if v1:
        yield from (("Dense_0", "fc1"), ("Dense_1", "fc2"))
    else:
        yield "Conv_0", "head"


def _is_v1_tree(params: Dict) -> bool:
    return "GoogLeNetBackbone_0" in params


def _is_v1_named(named: Dict) -> bool:
    return "fc1.weight" in named


def _to_torch_layout(kernel: np.ndarray) -> np.ndarray:
    """flax conv [kh, kw, in, out] or Dense [in, out] -> PyTorch layout."""
    return kernel.transpose(3, 2, 0, 1) if kernel.ndim == 4 else kernel.T


def _to_flax_layout(weight: np.ndarray) -> np.ndarray:
    return weight.transpose(2, 3, 1, 0) if weight.ndim == 4 else weight.T


def _at(tree: Dict, path: Tuple[str, ...]) -> Dict:
    for key in path:
        tree = tree[key]
    return tree


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


def params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """A flax YOLOv1 or YOLOv2 ``params``-shaped tree (the parameters
    themselves, or the momentum tree, which has the same layout) ->
    ``{parameter name: CPU float32 tensor}`` in the port's names."""
    v1 = _is_v1_tree(params)
    out = {}
    for path, prefix in _blocks(v1):
        p = _at(params, path)
        out[f"{prefix}.conv.weight"] = _t(
            _to_torch_layout(p["Conv_0"]["kernel"]))
        if "bias" in p["Conv_0"]:
            out[f"{prefix}.conv.bias"] = _t(p["Conv_0"]["bias"])
        out[f"{prefix}.bn.weight"] = _t(p["BatchNorm_0"]["scale"])
        out[f"{prefix}.bn.bias"] = _t(p["BatchNorm_0"]["bias"])
    for flax_name, name in _heads(v1):
        layer = params[flax_name]
        out[f"{name}.weight"] = _t(_to_torch_layout(layer["kernel"]))
        out[f"{name}.bias"] = _t(layer["bias"])
    return out


def jax_params_from(named: Dict[str, torch.Tensor]) -> Dict:
    """The inverse of :func:`params_from_jax`: numpy leaves in the flax
    ``params`` layout (other entries of ``named`` are ignored)."""
    def a(name):
        return named[name].detach().cpu().float().numpy().copy()

    v1 = _is_v1_named(named)
    params: Dict = {}
    for path, prefix in _blocks(v1):
        p = params
        for key in path:
            p = p.setdefault(key, {})
        p["Conv_0"] = {"kernel": _to_flax_layout(a(f"{prefix}.conv.weight"))}
        if f"{prefix}.conv.bias" in named:
            p["Conv_0"]["bias"] = a(f"{prefix}.conv.bias")
        p["BatchNorm_0"] = {
            "scale": a(f"{prefix}.bn.weight"),
            "bias": a(f"{prefix}.bn.bias"),
        }
    for flax_name, name in _heads(v1):
        params[flax_name] = {
            "kernel": _to_flax_layout(a(f"{name}.weight")),
            "bias": a(f"{name}.bias"),
        }
    return params


def state_dict_from_jax(variables: Dict) -> Dict[str, torch.Tensor]:
    """flax YOLOv1 or YOLOv2 variables (numpy leaves) -> the port's model
    ``state_dict`` (CPU float32 tensors)."""
    sd = params_from_jax(variables["params"])
    for path, prefix in _blocks(_is_v1_tree(variables["params"])):
        s = _at(variables["batch_stats"], path)
        sd[f"{prefix}.bn.running_mean"] = _t(s["BatchNorm_0"]["mean"])
        sd[f"{prefix}.bn.running_var"] = _t(s["BatchNorm_0"]["var"])
    return sd


def jax_from_state_dict(sd: Dict[str, torch.Tensor]) -> Dict:
    """The inverse: a ``YOLOv1`` or ``YOLOv2`` ``state_dict`` -> flax
    variables tree with numpy leaves."""
    stats: Dict = {}
    for path, prefix in _blocks(_is_v1_named(sd)):
        s = stats
        for key in path:
            s = s.setdefault(key, {})
        s["BatchNorm_0"] = {
            "mean": sd[f"{prefix}.bn.running_mean"].detach().cpu().float().numpy().copy(),
            "var": sd[f"{prefix}.bn.running_var"].detach().cpu().float().numpy().copy(),
        }
    return {"params": jax_params_from(sd), "batch_stats": stats}


def train_state_from_jax(tree: Dict) -> Dict:
    """A JAX ``TrainState`` as a numpy tree (``params``, ``batch_stats``,
    ``momentum``, ``step``) -> the port's ``TrainState.state_dict()``
    layout (``model``, ``momentum``, ``step``)."""
    return {
        "model": state_dict_from_jax(tree),
        "momentum": params_from_jax(tree["momentum"]),
        "step": int(tree["step"]),
    }


def jax_from_train_state(sd: Dict) -> Dict:
    """The inverse: ``TrainState.state_dict()`` -> numpy tree with the JAX
    ``TrainState``'s fields."""
    tree = jax_from_state_dict(sd["model"])
    tree["momentum"] = jax_params_from(sd["momentum"])
    tree["step"] = np.asarray(sd["step"], np.int32)
    return tree


def load_jax_yolov2(model, variables: Dict):
    """Copy flax YOLOv2 variables (numpy leaves) into the port's ``model``
    (strict: every parameter and buffer must match).  Returns ``model``."""
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def load_jax_yolov1(model, variables: Dict):
    """Copy flax YOLOv1 variables (numpy leaves) into the port's ``model``
    (strict, as :func:`load_jax_yolov2`).  Returns ``model``."""
    return load_jax_yolov2(model, variables)
