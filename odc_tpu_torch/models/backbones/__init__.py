from odc_tpu_torch.models.backbones.darknet19 import Darknet19Backbone
from odc_tpu_torch.models.backbones.googlenet import GoogLeNetBackbone

__all__ = ["Darknet19Backbone", "GoogLeNetBackbone"]
