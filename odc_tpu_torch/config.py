"""Config dataclasses (the port's own copy of ``odc_tpu/config.py``).

Same keys as the JAX package — ``MODEL_CONFIG`` / ``TRAIN_CONFIG`` with
``learning_rate_list``, ``num_epoch_list`` and the ``lambda_*`` loss
weights — so a run configured for one package configures the other.
``MeshConfig`` keeps the JAX package's (data, model) axes: ``data`` is the
number of data-parallel ranks and ``model`` the number of ranks that share
each wide kernel's output channels (``parallel/mesh.py``); ``DEVICE`` is
the default mesh, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple


@dataclasses.dataclass
class MeshConfig:
    """How training spreads over processes: ``data`` data-parallel ranks
    (-1: the launcher's world size over ``model``) and ``model``
    tensor-parallel shards of every kernel with at least 512 outputs;
    ``data * model`` processes in all, one per rank."""

    data: int = -1
    model: int = 1


DEVICE = MeshConfig()


@dataclasses.dataclass
class ModelConfig:
    name: str = "YOLOv2"
    num_grid_cell_in_height: int = 7
    num_grid_cell_in_width: int = 7
    num_anchor_box: int = 2
    num_cls: int = 20
    image_size: Tuple[int, int] = (416, 416)
    compute_dtype: str = "bfloat16"  # "float32" for parity runs


@dataclasses.dataclass
class TrainConfig:
    learning_rate_list: List[float] = dataclasses.field(
        default_factory=lambda: [1e-3, 1e-4, 1e-5]
    )
    num_epoch_list: List[int] = dataclasses.field(
        default_factory=lambda: [60, 30, 70]
    )
    lambda_xy: float = 5.0
    lambda_wh: float = 5.0
    lambda_conf: float = 1.0
    lambda_noobj: float = 0.5
    lambda_cls: float = 1.0

    batch_size: int = 32
    # 0.0 reproduces the reference's effective update (it re-creates SGD
    # each step, so momentum is inert); 0.9 is the intended behaviour.
    momentum: float = 0.0
    weight_decay: float = 5e-4
    warmup_first_epoch: bool = True  # lr / 10^(1 - progress) over epoch 1
    max_boxes: int = 64
    multiscale_sizes: Tuple[int, ...] = tuple(32 * s for s in range(10, 20))
    # "reference": one random size, picked at epoch 1 (the reference's
    # operator-precedence bug); "every10": a new size every 10 epochs.
    multiscale_policy: str = "reference"
    # "per_image": the reference's bs=1 validation loss (each image's means
    # over its own boxes, then the mean over images); "batched": batch-global
    # counts.  Best-checkpoint selection reads this number.
    val_loss_mode: str = "per_image"
    seed: int = 0


BATCH_SIZE = 32

MODEL_CONFIG: Dict[str, ModelConfig] = {
    "YOLOv1": ModelConfig(
        name="YOLOv1",
        num_grid_cell_in_height=7,
        num_grid_cell_in_width=7,
        num_anchor_box=2,
        image_size=(224, 224),
    ),
    "YOLOv2": ModelConfig(name="YOLOv2", image_size=(416, 416)),
    "YOLOv3": ModelConfig(
        name="YOLOv3", num_anchor_box=3, image_size=(416, 416)
    ),
}

TRAIN_CONFIG: Dict[str, Dict[str, TrainConfig]] = {
    "YOLOv1": {
        "VOC2012": TrainConfig(
            learning_rate_list=[1e-2, 1e-3, 1e-4],
            num_epoch_list=[150, 60, 60],
        )
    },
    "YOLOv2": {
        "VOC2012": TrainConfig(
            learning_rate_list=[1e-3, 1e-4, 1e-5],
            num_epoch_list=[60, 30, 70],
        )
    },
    "YOLOv3": {
        "VOC2012": TrainConfig(
            learning_rate_list=[1e-3, 1e-4, 1e-5],
            num_epoch_list=[60, 30, 70],
            lambda_xy=1.0,
            lambda_wh=1.0,
        )
    },
}


def as_dict(cfg) -> dict:
    """Dataclass -> plain dict."""
    return dataclasses.asdict(cfg)
