"""Multi-process data and model parallelism over ``torch.distributed``.

The counterpart of the JAX package's (data, model) device mesh
(``odc_tpu/parallel/mesh.py``).  One process per rank (``torchrun``); the
ranks lay out row-major on a ``data x model`` grid, as ``make_mesh``'s
``reshape(data, model)``: rank ``r`` is data index ``r // model`` and
model index ``r % model`` (:func:`make_mesh`).

The data axis: each data index holds its contiguous slice of every global
batch (``DetectionPipeline(process_index=, process_count=)``).  What XLA
does under the JAX mesh is spelled out here:

* :func:`broadcast_state` sends data index 0's parameters, buffers and
  momentum to the other data indices (JAX replicates the state);
* the loss divides by GLOBAL counts (``losses/``: ``count_sum``), so each
  rank's loss is its share of the global batch's loss, and
  :func:`all_reduce_grads` SUMS the gradients over the data axis in one
  flat bucket;
* every ``TorchBatchNorm`` in train mode reduces its statistics over the
  data axis, differentiably (:meth:`DataParallel.attach`), as the JAX step
  computes BN over the global batch;
* the in-step augmentation draws the global batch's parameters and keeps
  the data index's rows.

The model axis (:func:`shard_model`): every conv or ``Linear`` weight with
at least 512 outputs (``_MIN_SHARD_CHANNELS``, the JAX package's
``_param_spec``) keeps only its slice of output channels on each model
rank, as GSPMD shards the kernel's last axis over ``model``; everything
else is replicated.  The ranks of one model group hold the same data rows
and draw the same augmentation and dropout (the trainer seeds every rank
alike), so they compute the same replicated activations: a sharded layer's
input enters through an identity whose backward sums the input gradient
over the model group, the local conv or matmul runs on the weight slice,
the slices are all-gathered along the channel axis (backward: the rank's
slice of the gradient), and the replicated bias follows.  Splits need not
be even (``tensor_split``; the gather pads to the largest slice), as GSPMD
pads the 1470-wide YOLOv1 head over 4.  The replicated parameters' updates
stay equal across a model group because every rank takes model rank 0's
gradients of them (:func:`all_reduce_grads`).  Checkpoints are written
gathered (:class:`ModelShard`, ``TrainState.state_dict``), in the
one-card format.  The int8 engine, its calibration and the QAT twin run
sharded too (``ops/int8_engine.py``, ``ops/qat.py``), through
:func:`shard_of` and :func:`gather_channels`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist

# Output-channel shard threshold: narrower kernels replicate (the
# collectives would cost more than the slice saves).
_MIN_SHARD_CHANNELS = 512


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """One rank's place on the (data, model) mesh.

    ``rank``, ``world_size`` and ``group`` are the DATA axis: the rank's
    data index, the number of data indices and the group of the ranks that
    share its model index (None: the default group, when there is no model
    axis).  Every use of the data-parallel rank (the pipeline's and the
    augmentation's row slices, the evaluator's batches, BN's global
    statistics, the gradient and metric sums) reads these.
    ``model_rank``, ``model_size`` and ``model_group`` are the model axis:
    the ranks that share the rank's data index, and so its rows.
    ``global_rank`` is the process's rank in the world; the writer of
    checkpoints and metrics is global rank 0.  ``device``: the rank's
    card (or the CPU)."""

    rank: int
    world_size: int
    device: torch.device
    group: Any = None
    model_rank: int = 0
    model_size: int = 1
    model_group: Any = None
    global_rank: int = 0

    @property
    def is_writer(self) -> bool:
        return self.global_rank == 0

    def sum_counts(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the data axis of a count (no gradient flows through
        it)."""
        t = t.detach().clone()
        dist.all_reduce(t, group=self.group)
        return t

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the data axis, in place; returns it."""
        dist.all_reduce(t, group=self.group)
        return t

    def attach(self, model: torch.nn.Module) -> None:
        """Make every ``TorchBatchNorm`` of ``model`` reduce its train-mode
        statistics over the data axis (idempotent)."""
        from odc_tpu_torch.models.layers import TorchBatchNorm

        for m in model.modules():
            if isinstance(m, TorchBatchNorm):
                m.sync_group = self.group
                m.synced = True


def maybe_initialize_distributed(
    device: str = "cuda",
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
) -> Optional[DataParallel]:
    """Join the process group and return this rank's descriptor (every
    rank on the data axis, see :func:`make_mesh` for a model axis), or
    None in a single process (no ``WORLD_SIZE`` > 1 in the environment and
    no ``init_method``).

    Under ``torchrun`` the group comes from ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``; an explicit
    ``init_method`` (``tcp://localhost:<port>``) takes ``world_size`` and
    ``rank`` from the arguments or the environment.  The backend is
    ``nccl`` for a CUDA ``device`` (the rank's card is ``cuda:<LOCAL_RANK>``)
    and ``gloo`` on the CPU.  A group that is already up is reused, with
    its backend."""
    env = os.environ
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(env.get("RANK", "0"))
    if init_method is None and world_size <= 1 and not dist.is_initialized():
        return None
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(env.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=init_method or "env://",
            world_size=world_size, rank=rank,
            **({"device_id": dev} if dev.type == "cuda" else {}),
        )
    return DataParallel(dist.get_rank(), dist.get_world_size(), dev,
                        global_rank=dist.get_rank())


def check_mesh(mesh, dp: Optional[DataParallel]) -> int:
    """The data-axis size of ``mesh`` (a ``config.MeshConfig``) for this
    launch: ``data * model`` must equal the world size (``data`` -1: the
    world size over ``model``)."""
    world = 1 if dp is None else dp.world_size * dp.model_size
    if mesh.model < 1:
        raise ValueError(f"model parallelism must be at least 1, got "
                         f"{mesh.model}")
    if mesh.data == -1:
        if world % mesh.model:
            raise ValueError(
                f"model parallelism ({mesh.model}) is not supported by the "
                f"{world} process(es) launched: data x model must equal "
                "the world size (start data x model processes, e.g. "
                f"torchrun --nproc-per-node {mesh.model})")
        return world // mesh.model
    if mesh.data * mesh.model != world:
        raise ValueError(
            f"data parallelism {mesh.data} x model parallelism "
            f"{mesh.model} differs from the {world} process(es) launched "
            "(start one process per rank, e.g. torchrun --nproc-per-node "
            f"{mesh.data * mesh.model})")
    return mesh.data


def make_mesh(dp: DataParallel, model: int) -> DataParallel:
    """This rank's place on a (world / ``model``, ``model``) mesh of
    ``dp``'s world, row-major as the JAX package's ``make_mesh``: rank
    ``r`` is data index ``r // model``, model index ``r % model``.  Every
    rank must call it (it creates every data and model group, in one
    order).  ``model`` 1 returns ``dp``."""
    if model == 1:
        return dp
    world = dp.world_size * dp.model_size
    if world % model:
        raise ValueError(f"{world} processes do not split into model "
                         f"groups of {model}")
    data = world // model
    data_groups = [dist.new_group([d * model + m for d in range(data)])
                   for m in range(model)]
    model_groups = [dist.new_group([d * model + m for m in range(model)])
                    for d in range(data)]
    d, m = divmod(dp.global_rank, model)
    return DataParallel(d, data, dp.device, data_groups[m], m, model,
                        model_groups[d], dp.global_rank)


# -- the model axis ----------------------------------------------------------


class _EnterModel(torch.autograd.Function):
    """The identity; backward sums the gradient over the model group (each
    rank's slice of the layer reads the whole input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()  # autograd may hand one buffer to two branches
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherModel(torch.autograd.Function):
    """All-gather of the ranks' channel slices along the last axis;
    backward keeps the rank's slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, y, shard):
        ctx.shard = shard
        return shard.gather_full(y, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        return ctx.shard.local(grad, dim=-1).contiguous(), None


class ModelShard:
    """One rank's slice of a layer's ``full`` output channels over the
    model group ``group`` of ``size`` ranks: ``torch.tensor_split``'s
    slices (1470 over 4: 368, 368, 367, 367), the rank's starting at
    ``start``."""

    def __init__(self, group, rank: int, size: int, full: int):
        self.group, self.rank, self.size, self.full = group, rank, size, full
        self.sizes = [len(c) for c in torch.arange(full).tensor_split(size)]
        self.start = sum(self.sizes[:rank])

    def local(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The rank's slice of a full tensor along ``dim``."""
        if t.shape[dim] != self.full:
            raise ValueError(f"expected {self.full} channels on dim {dim}, "
                             f"got {t.shape[dim]}")
        return t.narrow(dim, self.start, self.sizes[self.rank])

    def gather_full(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ranks' slices along ``dim``, concatenated (no gradient)."""
        t = self._padded(t, dim)
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return self._joined(parts, dim)

    def _padded(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The rank's slice zero-padded to the largest along ``dim`` (the
        all-gather takes equal shapes)."""
        shape = list(t.shape)
        shape[dim] = max(self.sizes) - shape[dim]
        if shape[dim]:
            t = torch.cat([t, t.new_zeros(shape)], dim=dim)
        return t.contiguous()

    def _joined(self, parts, dim: int) -> torch.Tensor:
        """The gathered padded slices cut back and concatenated."""
        return torch.cat([p.narrow(dim, 0, n)
                          for p, n in zip(parts, self.sizes)], dim=dim)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _EnterModel.apply(x, self.group)

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        return _GatherModel.apply(y, self)


def shard_of(layer) -> Optional[ModelShard]:
    """The shard of a layer's output channels over the model axis (of a
    layer or its sharded weight, as ``shard_model`` marks both), or None
    where it is replicated."""
    return getattr(layer, "model_shard", None)


def gather_channels(shard: Optional[ModelShard],
                    t: torch.Tensor) -> torch.Tensor:
    """The model group's slices of ``t`` along its last (channel) axis,
    concatenated (no gradient flows through an all-gather); ``t`` itself
    when ``shard`` is None, with nothing added to a graph that
    ``torch.export`` captures.  Any dtype the backend carries: the int8
    engine gathers its int8 codes, never their float values."""
    return t if shard is None else shard.gather_full(t, dim=-1)


def model_axis_layers(model: torch.nn.Module) -> List[Tuple[str, Any]]:
    """(name, layer) of every conv or ``Linear`` of ``model`` whose weight
    has at least ``_MIN_SHARD_CHANNELS`` outputs: the layers the model axis
    shards, as the JAX package's ``_param_spec`` marks a ``kernel`` whose
    last axis is that wide."""
    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))
            and m.weight.shape[0] >= _MIN_SHARD_CHANNELS]


def model_shards(model: torch.nn.Module) -> Dict[str, ModelShard]:
    """``{parameter name: shard}`` of ``model``'s sharded weights (empty
    for a model with no model axis)."""
    return {f"{name}.weight": m.model_shard
            for name, m in model.named_modules()
            if shard_of(m) is not None}


@torch.no_grad()
def shard_model(model: torch.nn.Module, dp: DataParallel) -> None:
    """Place ``model`` on the mesh's model axis, in place: global rank 0's
    parameters and buffers are sent to every rank, then each rank keeps
    only its slice of the output channels of every layer of
    :func:`model_axis_layers` (``layer.model_shard``, read by
    ``models/layers.py::apply_layer``, and the same on the new weight
    parameter, read by :func:`all_reduce_grads`).  Build the
    ``TrainState`` after this (its momentum mirrors the slices).  A model
    with no model axis (``dp.model_size`` 1) is left as it is."""
    if dp.model_size == 1:
        return
    if model_shards(model):
        raise ValueError("the model is sharded already")
    layers = model_axis_layers(model)
    for name, layer in layers:
        if not getattr(layer, "model_shardable", False):
            raise ValueError(f"{name}: {layer.weight.shape[0]} outputs, but "
                             "its forward does not run sharded (apply_layer)")
    for t in (*model.parameters(), *model.buffers()):
        dist.broadcast(t, src=0)
    for _, layer in layers:
        shard = ModelShard(dp.model_group, dp.model_rank, dp.model_size,
                           layer.weight.shape[0])
        layer.weight = torch.nn.Parameter(shard.local(layer.weight).clone())
        layer.model_shard = layer.weight.model_shard = shard


@torch.no_grad()
def broadcast_state(state, dp: DataParallel) -> None:
    """Send data index 0's parameters, buffers and momentum buffers to the
    other data indices, in place (a ``TrainState``; the source of each
    data group is its rank at data index 0, global rank ``model_rank``)."""
    tensors = [*state.model.parameters(), *state.model.buffers(),
               *(state.momentum[n] for n in sorted(state.momentum))]
    for t in tensors:
        dist.broadcast(t, src=dp.model_rank, group=dp.group)


def _in_one_bucket(tensors: List[torch.Tensor], collective) -> None:
    """Run ``collective`` on the tensors concatenated flat, in place."""
    bucket = torch.cat([t.reshape(-1) for t in tensors])
    collective(bucket)
    torch._foreach_copy_(
        tensors, [b.view_as(t) for b, t in
                  zip(bucket.split([t.numel() for t in tensors]), tensors)])


@torch.no_grad()
def all_reduce_grads(params: Iterable[torch.nn.Parameter],
                     dp: DataParallel) -> None:
    """Sum the parameters' ``.grad`` over the data axis in one flat bucket,
    in place (a missing gradient counts as zeros).  On a model axis each
    rank sums its own slices, then every rank of a model group takes model
    rank 0's gradients of the replicated parameters: each rank computes
    them whole, and where the backward kernels are not deterministic (a
    card's cuDNN weight gradients) they differ in the last bits, so the
    replicas would drift apart step by step."""
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    _in_one_bucket([p.grad for p in params],
                   lambda b: dist.all_reduce(b, group=dp.group))
    if dp.model_size > 1:
        _in_one_bucket(
            [p.grad for p in params if shard_of(p) is None],
            lambda b: dist.broadcast(b, src=dp.global_rank - dp.model_rank,
                                     group=dp.model_group))


@contextlib.contextmanager
def rank_zero_first(dp: Optional[DataParallel]):
    """Run the body on global rank 0 first, then on the other ranks (a
    file that rank 0 writes, such as a dataset cache, is complete when
    they read it)."""
    if dp is None:
        yield
        return
    if not dp.is_writer:
        dist.barrier()
    yield
    if dp.is_writer:
        dist.barrier()
