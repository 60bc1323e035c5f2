"""Staged LR schedule + epoch-1 warmup (the port's own copy of
``odc_tpu/train/schedule.py``).

Reference semantics: stages are
``zip(learning_rate_list, num_epoch_list)``; during epoch 1 every step uses
``lr / 10^(1 - progress)`` where progress is the fraction of the dataset
seen so far (a smooth ramp from lr/10 to lr); afterwards the stage lr is
constant.
"""

from __future__ import annotations

from typing import List, Sequence


class StagedSchedule:
    def __init__(
        self,
        learning_rate_list: Sequence[float],
        num_epoch_list: Sequence[int],
        warmup_first_epoch: bool = True,
    ) -> None:
        if len(learning_rate_list) != len(num_epoch_list):
            raise ValueError("lr/epoch stage lists must be equal length")
        self.learning_rate_list = list(learning_rate_list)
        self.num_epoch_list = list(num_epoch_list)
        self.warmup_first_epoch = warmup_first_epoch

    @property
    def total_epochs(self) -> int:
        return sum(self.num_epoch_list)

    def stage_lr(self, epoch: int) -> float:
        """Stage lr for a 1-based cumulative epoch number."""
        cum = 0
        for lr, n in zip(self.learning_rate_list, self.num_epoch_list):
            cum += n
            if epoch <= cum:
                return lr
        return self.learning_rate_list[-1]

    def step_lr(self, epoch: int, progress: float) -> float:
        """Per-step lr; ``progress`` in (0, 1] is the dataset fraction seen
        (reference: progress_size / dataset_size)."""
        lr = self.stage_lr(epoch)
        if self.warmup_first_epoch and epoch == 1:
            return lr / (10.0 ** (1.0 - progress))
        return lr

    def epochs(self) -> List[int]:
        """1-based cumulative epoch numbers across all stages."""
        return list(range(1, self.total_epochs + 1))
