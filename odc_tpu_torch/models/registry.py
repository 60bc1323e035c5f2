"""Model registry: the models of the port by the JAX package's names
(``odc_tpu/models/registry.py``), and YOLOv4, which only the port has."""

from __future__ import annotations

from typing import Any, Dict

from odc_tpu_torch.models.yolov1 import YOLOv1
from odc_tpu_torch.models.yolov2 import YOLOv2
from odc_tpu_torch.models.yolov3 import YOLOv3
from odc_tpu_torch.models.yolov4 import YOLOv4

MODEL_REGISTRY: Dict[str, Any] = {
    "YOLOv1": YOLOv1,
    "YOLOv2": YOLOv2,
    "YOLOv3": YOLOv3,
    "YOLOv4": YOLOv4,
}


def model_class(name: str):
    """``MODEL_REGISTRY[name]``; ``KeyError`` for an unknown name."""
    if name not in MODEL_REGISTRY:
        raise KeyError(
            f"unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}"
        )
    return MODEL_REGISTRY[name]


def get_model(name: str, **kwargs):
    """``model_class(name)(**kwargs)``."""
    return model_class(name)(**kwargs)


def model_from_config(cfg, **kwargs):
    """The model ``cfg.name`` (a ``config.ModelConfig``) built from the
    fields of ``cfg`` its class takes (``config_fields``), plus
    ``kwargs``."""
    cls = model_class(cfg.name)
    return cls(**{f: getattr(cfg, f) for f in cls.config_fields}, **kwargs)
