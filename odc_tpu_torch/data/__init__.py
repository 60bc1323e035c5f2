from odc_tpu_torch.data.voc import VOC, VOCDataset, CLASS_LIST
from odc_tpu_torch.data.pipeline import DetectionPipeline, Batch

__all__ = ["VOC", "VOCDataset", "CLASS_LIST", "DetectionPipeline", "Batch"]
