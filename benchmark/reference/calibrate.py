"""Set-up rules the benchmark applies with its own reference.

``calibrate_bn``: every BatchNorm's running statistics from one float32
forward over a few seeded images, layer by layer, then randomised (mean +
0.2 sigma N(0, 1), variance x U(0.5, 1.5)).  Random weights then keep a
trained network's O(1) activations through every layer, and the BN folding
is not trivial.

``gap_threshold``: a confidence threshold in the middle of the largest gap
between adjacent sorted confidences within a band of ranks, so the NMS has
work and few candidates sit near the threshold.
"""

from __future__ import annotations

import torch

from benchmark.reference import nets


@torch.no_grad()
def calibrate_bn(cfg: dict, sd: dict, images_u8: torch.Tensor, seed: int) -> None:
    """Set ``sd``'s running statistics in place (see the module docstring);
    the jitter comes from a CPU generator seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)

    def set_stats(name: str, x: torch.Tensor) -> None:
        var, mean = torch.var_mean(x.float(), dim=(0, 2, 3), correction=1)
        n = mean.numel()
        jitter = torch.randn(n, generator=gen).to(x.device)
        scale = (0.5 + torch.rand(n, generator=gen)).to(x.device)
        sd[name + ".running_mean"].copy_(mean + 0.2 * jitter * var.sqrt())
        sd[name + ".running_var"].copy_(var * scale)

    nets.net(cfg, sd, on_bn=set_stats).forward(images_u8)


def gap_threshold(conf: torch.Tensor, lo: int, hi: int) -> float:
    """Midpoint of the largest gap between adjacent sorted confidences
    between ranks ``lo`` and ``hi`` (descending)."""
    s = conf.flatten().double().sort(descending=True).values
    hi = min(hi, s.numel() - 1)
    r = lo + int((s[lo:hi] - s[lo + 1:hi + 1]).argmax())
    return float((s[r] + s[r + 1]) / 2)
