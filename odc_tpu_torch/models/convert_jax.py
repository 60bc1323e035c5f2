"""JAX (flax) <-> PyTorch weight bridge for YOLOv1, YOLOv2 and YOLOv3.

The inverse of ``odc_tpu/models/convert_torch.py``'s layout:

* flax ``kernel`` [kh, kw, in, out] <-> conv ``weight`` [out, in, kh, kw];
* flax Dense ``kernel`` [in, out] <-> ``Linear.weight`` [out, in];
* flax BN ``scale``/``bias`` plus ``batch_stats`` ``mean``/``var`` <->
  ``weight``/``bias``/``running_mean``/``running_var``.

The flax side is a ``variables`` tree already turned into nested dicts of
numpy arrays (``{"params": ..., "batch_stats": ...}``); a whole train state
adds ``momentum`` (same layout as ``params``) and ``step``.  This module
imports neither JAX nor flax.  The model is read off the tree itself
(``GoogLeNetBackbone_0`` or ``fc1.weight`` mean YOLOv1,
``Darknet53Backbone_0`` or ``backbone.stem.conv.weight`` YOLOv3, whose
fused formulation has ``_LateralMerge_0`` or ``merge16``).  Flax numbers
modules by creation order, not by name.  Paths:

* YOLOv2: ``Darknet19Backbone_0/stage{k}/ConvBnLeaky_{i}`` (backbone),
  ``ConvBnLeaky_0`` (the 3x3 neck conv), ``Conv_0`` (the head);
* YOLOv1: ``GoogLeNetBackbone_0/BasicConv2d_{0..2}`` (stem convs),
  ``GoogLeNetBackbone_0/Inception_{0..8}/BasicConv2d_{0..5}`` (torchvision
  order), ``Dense_0`` and ``Dense_1``;
* YOLOv3: ``Darknet53Backbone_0/ConvBnLeaky_0`` (stem), ``ConvBnLeaky_1..5``
  (the downsamples), ``_Residual_0..22/ConvBnLeaky_{0,1}`` in order; then
  ``_FiveConv_0..2`` (``ConvBnLeaky_0..4``, or ``0..3`` after a merge),
  ``_LateralMerge_0..1`` (``Conv_0`` with a bias, ``Conv_1`` without,
  ``TorchBatchNorm_0``), ``ConvBnLeaky_0..4`` = head-32 3x3, t4, head-16
  3x3, t3, head-8 3x3, and ``Conv_0..2`` the 1x1 head outputs, coarsest
  first.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from odc_tpu_torch.models.backbones.darknet19 import _STAGES
from odc_tpu_torch.models.backbones.darknet53 import _BLOCKS as _D53_BLOCKS
from odc_tpu_torch.models.backbones.googlenet import (
    _INCEPTIONS, INCEPTION_UNITS,
)

# The leaves of each kind of unit: (collection, flax sub-path, PyTorch
# suffix).  Kernels are transposed between the two layouts.
_BN = (("params", ("BatchNorm_0", "scale"), "bn.weight"),
       ("params", ("BatchNorm_0", "bias"), "bn.bias"),
       ("batch_stats", ("BatchNorm_0", "mean"), "bn.running_mean"),
       ("batch_stats", ("BatchNorm_0", "var"), "bn.running_var"))
_UNITS = {
    # Conv + BN (+ leaky or ReLU): ConvBnLeaky, and BasicConv2d (no bias).
    "cbl": (("params", ("Conv_0", "kernel"), "conv.weight"),
            ("params", ("Conv_0", "bias"), "conv.bias")) + _BN,
    "cb": (("params", ("Conv_0", "kernel"), "conv.weight"),) + _BN,
    # A bare conv or Dense layer.
    "layer": (("params", ("kernel",), "weight"),
              ("params", ("bias",), "bias")),
    # YOLOv3's fused top-down merge.
    "merge": (("params", ("Conv_0", "kernel"), "conv_r.weight"),
              ("params", ("Conv_0", "bias"), "conv_r.bias"),
              ("params", ("Conv_1", "kernel"), "conv_c.weight"))
    + tuple((c, ("TorchBatchNorm_0",) + sub[1:], name)
            for c, sub, name in _BN),
}


def _v3_units(fused: bool):
    d = "Darknet53Backbone_0"
    yield (d, "ConvBnLeaky_0"), "backbone.stem", "cbl"
    r = 0
    for i, (_, repeat) in enumerate(_D53_BLOCKS):
        yield (d, f"ConvBnLeaky_{i + 1}"), f"backbone.stages.{i}.0", "cbl"
        for j in range(repeat):
            for k, part in enumerate(("reduce", "expand")):
                yield ((d, f"_Residual_{r}", f"ConvBnLeaky_{k}"),
                       f"backbone.stages.{i}.{j + 1}.{part}", "cbl")
            r += 1
    for s, (scale, first) in enumerate((("32", True), ("16", not fused),
                                        ("8", not fused))):
        if s:  # the top-down step into this scale
            yield (f"ConvBnLeaky_{2 * s - 1}",), f"reduce{scale}", "cbl"
            if fused:
                yield (f"_LateralMerge_{s - 1}",), f"merge{scale}", "merge"
        for i in range(5 if first else 4):
            yield ((f"_FiveConv_{s}", f"ConvBnLeaky_{i}"),
                   f"five{scale}.layers.{i}", "cbl")
        yield (f"ConvBnLeaky_{2 * s}",), f"head{scale}", "cbl"
        yield (f"Conv_{s}",), f"out{scale}", "layer"


def _units(kind: str) -> Iterator[Tuple[Tuple[str, ...], str, str]]:
    """(flax path, PyTorch module name, unit kind) of every unit of the
    model ``kind`` ("v1", "v2", "v3" fused or "v3-concat")."""
    if kind == "v1":
        g = "GoogLeNetBackbone_0"
        for i, name in enumerate(("conv1", "conv2", "conv3")):
            yield (g, f"BasicConv2d_{i}"), f"backbone.{name}", "cb"
        for i, blk in enumerate(_INCEPTIONS):
            for j, unit in enumerate(INCEPTION_UNITS):
                yield ((g, f"Inception_{i}", f"BasicConv2d_{j}"),
                       f"backbone.inception{blk}.{unit}", "cb")
        yield ("Dense_0",), "fc1", "layer"
        yield ("Dense_1",), "fc2", "layer"
    elif kind == "v2":
        for k, stage in enumerate(_STAGES):
            for i in range(len(stage)):
                yield (("Darknet19Backbone_0", f"stage{k + 1}",
                        f"ConvBnLeaky_{i}"), f"backbone.stages.{k}.{i}",
                       "cbl")
        yield ("ConvBnLeaky_0",), "neck", "cbl"
        yield ("Conv_0",), "head", "layer"
    else:
        yield from _v3_units(kind == "v3")


def _leaves(kind: str, collection: str):
    """(flax path, PyTorch name) of every leaf of ``collection``."""
    for path, prefix, unit in _units(kind):
        for coll, sub, suffix in _UNITS[unit]:
            if coll == collection:
                yield path + sub, f"{prefix}.{suffix}"


def _tree_kind(params: Dict) -> str:
    if "GoogLeNetBackbone_0" in params:
        return "v1"
    if "Darknet53Backbone_0" in params:
        return "v3" if "_LateralMerge_0" in params else "v3-concat"
    return "v2"


def _named_kind(named: Dict) -> str:
    if "fc1.weight" in named:
        return "v1"
    if "backbone.stem.conv.weight" in named:
        return "v3" if "merge16.conv_r.weight" in named else "v3-concat"
    return "v2"


def _to_torch_layout(kernel: np.ndarray) -> np.ndarray:
    """flax conv [kh, kw, in, out] or Dense [in, out] -> PyTorch layout."""
    return kernel.transpose(3, 2, 0, 1) if kernel.ndim == 4 else kernel.T


def _to_flax_layout(weight: np.ndarray) -> np.ndarray:
    return weight.transpose(2, 3, 1, 0) if weight.ndim == 4 else weight.T


def _at(tree: Dict, path: Tuple[str, ...]):
    for key in path:
        tree = tree[key]
    return tree


def _put(tree: Dict, path: Tuple[str, ...], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _from_tree(tree: Dict, kind: str, collection: str):
    out = {}
    for path, name in _leaves(kind, collection):
        a = _at(tree, path)
        if path[-1] == "kernel":
            a = _to_torch_layout(a)
        out[name] = torch.tensor(np.asarray(a, dtype=np.float32))
    return out


def _to_tree(named: Dict, kind: str, collection: str) -> Dict:
    tree: Dict = {}
    for path, name in _leaves(kind, collection):
        a = named[name].detach().cpu().float().numpy().copy()
        _put(tree, path, _to_flax_layout(a) if path[-1] == "kernel" else a)
    return tree


def params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """A flax YOLOv1, YOLOv2 or YOLOv3 ``params``-shaped tree (the
    parameters themselves, or the momentum tree, which has the same
    layout) -> ``{parameter name: CPU float32 tensor}`` in the port's
    names."""
    return _from_tree(params, _tree_kind(params), "params")


def jax_params_from(named: Dict[str, torch.Tensor]) -> Dict:
    """The inverse of :func:`params_from_jax`: numpy leaves in the flax
    ``params`` layout (other entries of ``named`` are ignored)."""
    return _to_tree(named, _named_kind(named), "params")


def state_dict_from_jax(variables: Dict) -> Dict[str, torch.Tensor]:
    """flax YOLOv1, YOLOv2 or YOLOv3 variables (numpy leaves) -> the
    port's model ``state_dict`` (CPU float32 tensors)."""
    kind = _tree_kind(variables["params"])
    sd = _from_tree(variables["params"], kind, "params")
    sd.update(_from_tree(variables["batch_stats"], kind, "batch_stats"))
    return sd


def jax_from_state_dict(sd: Dict[str, torch.Tensor]) -> Dict:
    """The inverse: a ``YOLOv1``, ``YOLOv2`` or ``YOLOv3`` ``state_dict``
    -> flax variables tree with numpy leaves."""
    kind = _named_kind(sd)
    return {"params": _to_tree(sd, kind, "params"),
            "batch_stats": _to_tree(sd, kind, "batch_stats")}


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


def load_jax_yolov3(model, variables: Dict):
    """Copy flax YOLOv3 variables (numpy leaves), of either formulation,
    into the port's ``model`` of the same ``fused_lateral`` (strict, as
    :func:`load_jax_yolov2`).  Returns ``model``."""
    return load_jax_yolov2(model, variables)
