"""The least time of the conv blocks' fused inference epilogues, counted
from the function, whatever implements it (``counts.py``'s rule; its peaks).

bias + BatchNorm + Mish + cast to bf16 over a bf16 [M, C] conv output:
bytes, the map read once and written once (2 + 2 B an element) and five f32
[C] vectors (conv bias, mean, variance, scale, shift) once a launch;
operations, :data:`MISH_OPS` f32 operations an element: the bias add, BN's
subtract, two multiplies and add, and Mish's exp, log1p, tanh and multiply,
each transcendental counted as one operation.  At H100's rates the bytes
bound it: 4 B take 1.19 ps an element, the 9 operations 0.13 ps.
"""

from __future__ import annotations

from typing import Iterable, Tuple

from benchmark import counts

MISH_OPS = 9  # f32 operations an element (see the module docstring)


def bias_bn_mish_bound_s(batch: int, maps: Iterable[Tuple[int, int, int]]) -> float:
    """Least time of one launch a map, over ``maps`` (``(H, W, C)`` of each
    block's output) at ``batch`` images: the sum of each launch's bound."""
    total = 0.0
    for h, w, c in maps:
        elements = batch * h * w * c
        total += counts.bound_s(4.0 * elements + 5 * 4.0 * c,
                                float(MISH_OPS) * elements, counts.F32_FLOPS)
    return total
