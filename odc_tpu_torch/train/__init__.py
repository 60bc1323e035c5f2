from odc_tpu_torch.train.trainer import Trainer, TrainState, make_train_step
from odc_tpu_torch.train.schedule import StagedSchedule
from odc_tpu_torch.train import checkpoint


def __getattr__(name):
    # Lazy: the QAT driver pulls in the int8 engine; keep plain training
    # imports light.
    if name in ("finetune_qat", "calibrate_from_pipeline"):
        from odc_tpu_torch.train import qat

        return getattr(qat, name)
    raise AttributeError(name)


__all__ = [
    "Trainer",
    "TrainState",
    "make_train_step",
    "StagedSchedule",
    "checkpoint",
    "finetune_qat",
    "calibrate_from_pipeline",
]
