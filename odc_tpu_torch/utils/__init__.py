from odc_tpu_torch.utils.metrics import JsonlLogger

__all__ = ["JsonlLogger"]
