from odc_tpu_torch.models.registry import (
    MODEL_REGISTRY, get_model, model_from_config,
)
from odc_tpu_torch.models.yolov1 import YOLOv1
from odc_tpu_torch.models.yolov2 import YOLOv2
from odc_tpu_torch.models.yolov3 import YOLOv3
from odc_tpu_torch.models.yolov4 import YOLOv4

__all__ = ["MODEL_REGISTRY", "YOLOv1", "YOLOv2", "YOLOv3", "YOLOv4",
           "get_model", "model_from_config"]
