"""YOLOv1 network: GoogLeNet -> flatten -> Dense -> ReLU -> Dropout ->
Dense, reshaped to [N, Hg, Wg, A * 5 + C].

Port of ``odc_tpu/models/yolov1.py``: at 224x224 the backbone gives
[N, 7, 7, 1024], flattened NHWC row-major to 50176 features, then
Dense(50176 -> 4096), ReLU, Dropout(0.5) and Dense(4096 -> 7 * 7 * 30)
(S = 7, B = 2, C = 20).  The Dense layers keep float32 parameters and
compute in ``dtype``; the head comes out in float32.  On a mesh's model
axis both Dense layers (4096 and 1470 outputs) keep only their rank's
output rows (``models/layers.py::apply_layer``).

Dropout draws its mask from a ``torch.Generator`` passed to ``forward``,
never from PyTorch's global generator, so a training run's randomness is
the caller's (the trainer's device generator, as the JAX package's train
step passes ``rngs={"dropout": rng}``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from odc_tpu_torch import resolve_device
from odc_tpu_torch.models.backbones.googlenet import GoogLeNetBackbone
from odc_tpu_torch.models.layers import _conv_init_, apply_layer
from odc_tpu_torch.ops.decode import (
    Detections, decode_v1, decode_v1_preactivated,
)

HIDDEN = 4096
BACKBONE_FEATURES = 1024


def backbone_hw(image_size: Tuple[int, int]) -> Tuple[int, int]:
    """GoogLeNet's output size for an input of ``image_size``: the stride-2
    stem conv rounds up, each of the four ceil-mode pools halves down."""
    return tuple(((s + 1) // 2) // 16 for s in image_size)


def dropout(
    x: torch.Tensor, rate: float, generator: Optional[torch.Generator]
) -> torch.Tensor:
    """Inverted dropout as flax's ``nn.Dropout``: keep each element with
    probability ``1 - rate`` and scale it by ``1 / (1 - rate)``.  The mask
    is drawn from ``generator`` (on ``x``'s device)."""
    if generator is None:
        raise ValueError(
            "dropout in training mode needs a torch.Generator (pass "
            "generator=...; PyTorch's global generator is never used)")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


class YOLOv1(nn.Module):
    """YOLOv1, for inference (``.eval()``: running BN statistics, no
    dropout) and for training (``.train()``: batch BN statistics, dropout
    from the generator given to ``forward``).  Parameters are float32,
    drawn from a ``torch.Generator`` seeded with ``seed`` (PyTorch's default
    Conv2d and Linear init, BN at identity), built on the CPU and moved to
    ``device``; ``device`` defaults to ``"cuda"`` and raises if no card is
    present.  ``image_size`` fixes the first Dense layer's width."""

    mode = "v1"  # target assignment, loss and detect contract
    # The ``ModelConfig`` fields the constructor takes (``train.py``'s).
    config_fields = ("num_grid_cell_in_height", "num_grid_cell_in_width",
                     "num_anchor_box", "image_size")

    def __init__(
        self,
        num_grid_cell_in_height: int = 7,
        num_grid_cell_in_width: int = 7,
        num_anchor_box: int = 2,
        num_cls: int = 20,
        dtype: torch.dtype = torch.float32,
        image_size: Tuple[int, int] = (224, 224),
        dropout_rate: float = 0.5,
        legacy_sigmoid_head: bool = False,
        device="cuda",
        seed: int = 0,
    ):
        super().__init__()
        if not 0.0 <= dropout_rate < 1.0:
            raise ValueError(f"dropout_rate must be in [0, 1), got "
                             f"{dropout_rate}")
        dev = resolve_device(device)
        self.num_grid_cell_in_height = num_grid_cell_in_height
        self.num_grid_cell_in_width = num_grid_cell_in_width
        self.num_anchor_box = num_anchor_box
        self.num_cls = num_cls
        self.dtype = dtype
        self.image_size = tuple(image_size)
        self.dropout_rate = dropout_rate
        self.legacy_sigmoid_head = legacy_sigmoid_head
        self.out_dim = num_anchor_box * 5 + num_cls
        gen = torch.Generator().manual_seed(seed)
        self.backbone = GoogLeNetBackbone(dtype=dtype, generator=gen)
        fh, fw = backbone_hw(self.image_size)
        self.fc1 = nn.Linear(fh * fw * BACKBONE_FEATURES, HIDDEN)
        self.fc2 = nn.Linear(
            HIDDEN, num_grid_cell_in_height * num_grid_cell_in_width
            * self.out_dim)
        for fc in (self.fc1, self.fc2):
            _conv_init_(fc, gen)  # fan-in = weight[0].numel(), as for a conv
            # Through apply_layer: shardable over the mesh's model axis.
            fc.model_shardable = True
        self.to(dev)

    def forward(
        self, x: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        """[N, H, W, 3] RGB (0-255) -> raw head [N, Hg, Wg, A * 5 + C] f32.

        ``generator`` feeds dropout in training mode (required there when
        ``dropout_rate > 0``); eval mode ignores it."""
        n = x.shape[0]
        dt = self.dtype
        h = self.backbone(x).reshape(n, -1)  # NHWC row-major, as flax
        h = F.relu(apply_layer(self.fc1, h, F.linear, dt))
        if self.training and self.dropout_rate > 0:
            h = dropout(h, self.dropout_rate, generator)
        y = apply_layer(self.fc2, h, F.linear, dt)
        y = y.reshape(
            n, self.num_grid_cell_in_height, self.num_grid_cell_in_width,
            self.out_dim,
        ).float()
        if self.legacy_sigmoid_head:
            y = torch.sigmoid(y)
        return y

    def decode(self, y: torch.Tensor, image_hw=None) -> Detections:
        decode_fn = (decode_v1_preactivated if self.legacy_sigmoid_head
                     else decode_v1)
        return decode_fn(
            y, tuple(image_hw or self.image_size), self.num_anchor_box)
