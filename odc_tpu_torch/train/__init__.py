from odc_tpu_torch.train.trainer import Trainer, TrainState, make_train_step
from odc_tpu_torch.train.schedule import StagedSchedule
from odc_tpu_torch.train import checkpoint

__all__ = [
    "Trainer",
    "TrainState",
    "make_train_step",
    "StagedSchedule",
    "checkpoint",
]
