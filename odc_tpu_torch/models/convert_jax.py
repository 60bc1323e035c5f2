"""JAX (flax) <-> PyTorch weight bridge for YOLOv2.

The inverse of ``odc_tpu/models/convert_torch.py``'s layout:

* flax ``kernel`` [kh, kw, in, out] <-> ``weight`` [out, in, kh, kw];
* flax BN ``scale``/``bias`` plus ``batch_stats`` ``mean``/``var`` <->
  ``weight``/``bias``/``running_mean``/``running_var``.

The flax side is a ``variables`` tree already turned into nested dicts of
numpy arrays (``{"params": ..., "batch_stats": ...}``); a whole train state
adds ``momentum`` (same layout as ``params``) and ``step``.  This module
imports neither JAX nor flax.  Paths: ``Darknet19Backbone_0/stage{k}/ConvBnLeaky_{i}``
(backbone), ``ConvBnLeaky_0`` (the 3x3 neck conv), ``Conv_0`` (the head).
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from odc_tpu_torch.models.backbones.darknet19 import _STAGES


def _blocks() -> Iterator[Tuple[Tuple[str, ...], str]]:
    """(flax path of each ConvBnLeaky, matching PyTorch module prefix)."""
    for k, stage in enumerate(_STAGES):
        for i in range(len(stage)):
            yield (
                ("Darknet19Backbone_0", f"stage{k + 1}", f"ConvBnLeaky_{i}"),
                f"backbone.stages.{k}.{i}",
            )
    yield ("ConvBnLeaky_0",), "neck"


def _at(tree: Dict, path: Tuple[str, ...]) -> Dict:
    for key in path:
        tree = tree[key]
    return tree


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


def params_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """A flax YOLOv2 ``params``-shaped tree (the parameters themselves, or
    the momentum tree, which has the same layout) -> ``{parameter name:
    CPU float32 tensor}`` in the port's names."""
    out = {}
    for path, prefix in _blocks():
        p = _at(params, path)
        out[f"{prefix}.conv.weight"] = _t(p["Conv_0"]["kernel"].transpose(3, 2, 0, 1))
        out[f"{prefix}.conv.bias"] = _t(p["Conv_0"]["bias"])
        out[f"{prefix}.bn.weight"] = _t(p["BatchNorm_0"]["scale"])
        out[f"{prefix}.bn.bias"] = _t(p["BatchNorm_0"]["bias"])
    out["head.weight"] = _t(params["Conv_0"]["kernel"].transpose(3, 2, 0, 1))
    out["head.bias"] = _t(params["Conv_0"]["bias"])
    return out


def jax_params_from(named: Dict[str, torch.Tensor]) -> Dict:
    """The inverse of :func:`params_from_jax`: numpy leaves in the flax
    ``params`` layout (other entries of ``named`` are ignored)."""
    def a(name):
        return named[name].detach().cpu().float().numpy().copy()

    params: Dict = {}
    for path, prefix in _blocks():
        p = params
        for key in path:
            p = p.setdefault(key, {})
        p["Conv_0"] = {
            "kernel": a(f"{prefix}.conv.weight").transpose(2, 3, 1, 0),
            "bias": a(f"{prefix}.conv.bias"),
        }
        p["BatchNorm_0"] = {
            "scale": a(f"{prefix}.bn.weight"),
            "bias": a(f"{prefix}.bn.bias"),
        }
    params["Conv_0"] = {
        "kernel": a("head.weight").transpose(2, 3, 1, 0),
        "bias": a("head.bias"),
    }
    return params


def state_dict_from_jax(variables: Dict) -> Dict[str, torch.Tensor]:
    """flax YOLOv2 variables (numpy leaves) -> the port's ``YOLOv2``
    ``state_dict`` (CPU float32 tensors)."""
    sd = params_from_jax(variables["params"])
    for path, prefix in _blocks():
        s = _at(variables["batch_stats"], path)
        sd[f"{prefix}.bn.running_mean"] = _t(s["BatchNorm_0"]["mean"])
        sd[f"{prefix}.bn.running_var"] = _t(s["BatchNorm_0"]["var"])
    return sd


def jax_from_state_dict(sd: Dict[str, torch.Tensor]) -> Dict:
    """The inverse: a ``YOLOv2`` ``state_dict`` -> flax variables tree with
    numpy leaves."""
    stats: Dict = {}
    for path, prefix in _blocks():
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
