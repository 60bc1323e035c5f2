"""Multi-process data parallelism over ``torch.distributed``.

The counterpart of the JAX package's (data, model) device mesh, for the
data axis: one process per card (``torchrun``), each holding a full
replica of the train state and its contiguous slice of every global batch
(``DetectionPipeline(process_index=, process_count=)``).  What XLA does
under the JAX mesh is spelled out here:

* :func:`broadcast_state` sends rank 0's parameters, buffers and momentum
  to every rank (JAX replicates the state);
* the loss divides by GLOBAL counts (``losses/``: ``count_sum``), so each
  rank's loss is its share of the global batch's loss, and
  :func:`all_reduce_grads` SUMS the gradients in one flat bucket;
* every ``TorchBatchNorm`` in train mode reduces its statistics over the
  ranks, differentiably (:meth:`DataParallel.attach`), as the JAX step
  computes BN over the global batch;
* the in-step augmentation draws the global batch's parameters and keeps
  the rank's rows.

The JAX mesh's ``model`` axis (output channels of wide kernels sharded
across chips) has no counterpart: every model here fits one card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Iterable, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """One rank of a data-parallel group: its ``rank``, the ``world_size``,
    the process ``group`` (None: the default group) and the rank's
    ``device``."""

    rank: int
    world_size: int
    device: torch.device
    group: Any = None

    def sum_counts(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of a count (no gradient flows through it)."""
        t = t.detach().clone()
        dist.all_reduce(t, group=self.group)
        return t

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over ranks, in place; returns it."""
        dist.all_reduce(t, group=self.group)
        return t

    def attach(self, model: torch.nn.Module) -> None:
        """Make every ``TorchBatchNorm`` of ``model`` reduce its train-mode
        statistics over this group (idempotent)."""
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
    """Join the data-parallel group and return this rank's descriptor, or
    None in a single process (no ``WORLD_SIZE`` > 1 in the environment and
    no ``init_method``).

    Under ``torchrun`` the group comes from ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``; an explicit
    ``init_method`` (``tcp://localhost:<port>``) takes ``world_size`` and
    ``rank`` from the arguments or the environment.  The backend is
    ``nccl`` for a CUDA ``device`` (the rank's card is ``cuda:<LOCAL_RANK>``)
    and ``gloo`` on the CPU.  A group that is already up is reused."""
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
    return DataParallel(dist.get_rank(), dist.get_world_size(), dev)


def check_mesh(mesh, dp: Optional[DataParallel]) -> int:
    """The data-axis size of ``mesh`` (a ``config.MeshConfig``) for this
    launch: ``data`` -1 is the world size, any other value must equal it;
    ``model`` > 1 raises (sharding a model's kernels over cards has no
    counterpart here: every model fits one card)."""
    world = 1 if dp is None else dp.world_size
    if mesh.model != 1:
        raise ValueError(
            f"model parallelism ({mesh.model}) is not supported: every "
            "model trains on one card; the JAX package's model axis has no "
            "counterpart in this package")
    if mesh.data not in (-1, world):
        raise ValueError(
            f"data parallelism {mesh.data} differs from the {world} "
            "process(es) launched (start one process per rank, e.g. "
            f"torchrun --nproc-per-node {mesh.data})")
    return world


@torch.no_grad()
def broadcast_state(state, dp: DataParallel) -> None:
    """Send rank 0's parameters, buffers and momentum buffers to every rank,
    in place (a ``TrainState``)."""
    tensors = [*state.model.parameters(), *state.model.buffers(),
               *(state.momentum[n] for n in sorted(state.momentum))]
    for t in tensors:
        dist.broadcast(t, src=0, group=dp.group)


@torch.no_grad()
def all_reduce_grads(params: Iterable[torch.nn.Parameter],
                     dp: DataParallel) -> None:
    """Sum the parameters' ``.grad`` over ranks in one flat bucket, in place
    (a missing gradient counts as zeros)."""
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    bucket = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(bucket, group=dp.group)
    torch._foreach_copy_(
        grads, [b.view_as(g) for b, g in
                zip(bucket.split([g.numel() for g in grads]), grads)])


@contextlib.contextmanager
def rank_zero_first(dp: Optional[DataParallel]):
    """Run the body on rank 0 first, then on the other ranks (a file that
    rank 0 writes, such as a dataset cache, is complete when they read
    it)."""
    if dp is None:
        yield
        return
    if dp.rank != 0:
        dist.barrier(group=dp.group)
    yield
    if dp.rank == 0:
        dist.barrier(group=dp.group)
