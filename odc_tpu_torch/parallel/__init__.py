"""Multi-process data parallelism (the counterpart of
``odc_tpu/parallel/mesh.py``)."""

from odc_tpu_torch.parallel.mesh import (
    DataParallel,
    all_reduce_grads,
    broadcast_state,
    check_mesh,
    maybe_initialize_distributed,
    rank_zero_first,
)

__all__ = [
    "DataParallel",
    "all_reduce_grads",
    "broadcast_state",
    "check_mesh",
    "maybe_initialize_distributed",
    "rank_zero_first",
]
