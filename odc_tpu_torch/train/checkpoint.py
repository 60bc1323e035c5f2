"""Checkpoint save/restore.

Port of ``odc_tpu/train/checkpoint.py``: the same file layout
(``best_model.ckpt`` / ``final_model.ckpt``) holding the full train state
(parameters, BN buffers, momentum buffers, step), written with
``torch.save`` as CPU tensors and read back with
``torch.load(weights_only=True)``.  The JAX package's msgpack checkpoints
are a different format and are not read here.
"""

from __future__ import annotations

from typing import Dict

import torch


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree


def save(path: str, state) -> None:
    """Write ``state.state_dict()`` (a ``TrainState``) to ``path``."""
    torch.save(_cpu(state.state_dict()), path)


def restore(path: str, template):
    """Load a checkpoint into ``template`` (e.g. a freshly created
    ``TrainState``), in place, on the template's device.  Returns it."""
    template.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    return template


def save_params(path: str, params: Dict[str, torch.Tensor]) -> None:
    """Params-only checkpoint (deployment artifact): a ``{name: tensor}``
    dict such as ``dict(model.named_parameters())`` or a ``state_dict``."""
    torch.save(_cpu(dict(params)), path)


def restore_params(path: str, template: Dict[str, torch.Tensor]):
    """Read a params-only checkpoint; names and shapes must match
    ``template``, whose devices and dtypes the result takes."""
    loaded = torch.load(path, map_location="cpu", weights_only=True)
    if sorted(loaded) != sorted(template):
        raise KeyError("checkpoint names differ from the template's")
    out = {}
    for name, ref in template.items():
        if loaded[name].shape != ref.shape:
            raise ValueError(
                f"{name}: checkpoint shape {tuple(loaded[name].shape)} != "
                f"{tuple(ref.shape)}"
            )
        out[name] = loaded[name].to(device=ref.device, dtype=ref.dtype)
    return out
