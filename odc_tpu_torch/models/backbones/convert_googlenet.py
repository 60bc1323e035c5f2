"""torchvision GoogLeNet ``state_dict`` -> the port's ``GoogLeNetBackbone``.

Counterpart of ``odc_tpu/models/backbones/convert_googlenet.py``.  The
reference downloads pretrained weights through ``torch.hub``; here a
checkpoint that is already on disk (``googlenet-1378be20.pth``), or an
in-memory ``state_dict``, is loaded.  Nothing is downloaded.

The backbone carries torchvision's module names, so the mapping is one to
one.  Dropped: ``num_batches_tracked`` (the port's BatchNorm keeps no such
counter) and the classifier layers the reference's forward never runs
(``fc``, ``aux1``, ``aux2``).  Every other key must match a backbone
parameter or buffer in name and shape, and every one of those must be
given.
"""

from __future__ import annotations

from typing import Dict, Union

import torch

_SKIPPED_PREFIXES = ("fc.", "aux1.", "aux2.")


def load_torch_googlenet(
    backbone: torch.nn.Module,
    state_dict: Union[str, Dict[str, torch.Tensor]],
) -> torch.nn.Module:
    """Copy a torchvision GoogLeNet checkpoint (a ``state_dict`` or the path
    of a ``.pth`` file holding one) into ``backbone``, strictly.  Returns
    ``backbone``."""
    if isinstance(state_dict, str):
        state_dict = torch.load(state_dict, map_location="cpu",
                                weights_only=True)
    kept = {
        k: torch.as_tensor(v).float()
        for k, v in state_dict.items()
        if not k.endswith("num_batches_tracked")
        and not k.startswith(_SKIPPED_PREFIXES)
    }
    backbone.load_state_dict(kept, strict=True)
    return backbone
