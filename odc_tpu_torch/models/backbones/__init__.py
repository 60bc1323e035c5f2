from odc_tpu_torch.models.backbones.cspdarknet53 import CSPDarknet53Backbone
from odc_tpu_torch.models.backbones.darknet19 import Darknet19Backbone
from odc_tpu_torch.models.backbones.darknet53 import Darknet53Backbone
from odc_tpu_torch.models.backbones.googlenet import GoogLeNetBackbone

__all__ = ["CSPDarknet53Backbone", "Darknet19Backbone", "Darknet53Backbone",
           "GoogLeNetBackbone"]
