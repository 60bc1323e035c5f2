"""Small constant tensors on a device, made once.

``torch.tensor(values, device="cuda")`` copies from the host and blocks
until the copy is done; a CUDA graph cannot hold such a copy.  The decode
anchors and the ImageNet normalize take their constants from here: the
first call on a (values, dtype, device) makes the tensor, later calls get
the same one.  Under ``torch.compile`` or ``torch.export`` every call makes
its own, so a traced program holds the constant as before and the cache
never holds a traced tensor.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _made_once(values: tuple, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    # A normal tensor even when first asked for under inference mode:
    # training code (the v3 loss's decode) saves these for backward.
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def device_constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)`` for a flat or
    nested sequence of numbers, made once per (values, dtype, device) and
    shared: never write to it."""
    if torch.compiler.is_compiling():
        return torch.tensor(values, dtype=dtype, device=device)
    key = tuple(tuple(v) if isinstance(v, (list, tuple)) else v
                for v in values)
    return _made_once(key, dtype, torch.device(device))
