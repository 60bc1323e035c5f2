from odc_tpu_torch.core.ap import APAccumulator
from odc_tpu_torch.eval.evaluator import (
    Detector,
    evaluate_batched,
    evaluate_batched_native,
    evaluate_model,
)

__all__ = [
    "Detector",
    "evaluate_model",
    "evaluate_batched",
    "evaluate_batched_native",
    "APAccumulator",
]
