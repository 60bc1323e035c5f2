from odc_tpu_torch.losses.yolo_loss import yolo_loss, LossParts, Lambdas

__all__ = ["yolo_loss", "LossParts", "Lambdas"]
