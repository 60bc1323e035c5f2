"""Multi-process data and model parallelism (the counterpart of
``odc_tpu/parallel/mesh.py``)."""

from odc_tpu_torch.parallel.mesh import (
    DataParallel,
    ModelShard,
    all_reduce_grads,
    broadcast_state,
    check_mesh,
    make_mesh,
    maybe_initialize_distributed,
    model_axis_layers,
    model_shards,
    rank_zero_first,
    shard_model,
)

__all__ = [
    "DataParallel",
    "ModelShard",
    "all_reduce_grads",
    "broadcast_state",
    "check_mesh",
    "make_mesh",
    "maybe_initialize_distributed",
    "model_axis_layers",
    "model_shards",
    "rank_zero_first",
    "shard_model",
]
