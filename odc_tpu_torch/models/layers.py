"""Shared building blocks, NHWC at the boundaries.

Port of ``odc_tpu/models/layers.py``.  Modules take and return NHWC tensors
like the JAX package; inside, a convolution runs on the NCHW view of the
same memory (``permute`` of a contiguous NHWC tensor is a ``channels_last``
NCHW tensor, which cuDNN takes as is).  Parameters stay float32 and are cast
to the compute dtype at use; BatchNorm computes in float32 (float64 for a
float64 input).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from odc_tpu_torch.core.image import (  # noqa: F401  (re-exported)
    IMAGENET_MEAN, IMAGENET_STD, imagenet_normalize,
)
from odc_tpu_torch.utils.metrics import count, span


class TorchBatchNorm(nn.Module):
    """BatchNorm over the last (channel) dim, in float32 (float64 for a
    float64 input), with ``torch.nn.BatchNorm2d``'s running-statistics
    semantics:
    ``(x - mean) * rsqrt(var + eps) * weight + bias``.

    In eval mode ``mean``/``var`` are the running statistics.  In training
    mode they are the batch mean and the **biased** batch variance over
    N, H, W, and the running statistics move towards the batch mean and the
    **unbiased** variance (``n / max(n - 1, 1)``) with decay ``decay``
    (0.9, i.e. ``BatchNorm2d(momentum=0.1)``).

    Parameter names are ``torch.nn.BatchNorm2d``'s (``weight``, ``bias``,
    ``running_mean``, ``running_var``).

    Data parallelism (``synced``, set by ``parallel.DataParallel.attach``):
    the training-mode statistics are those of the GLOBAL batch, reduced
    over ``sync_group`` by :func:`global_var_mean`.

    ``keep_running_stats`` (set by :func:`rematerialize` while it
    recomputes a forward): the batch statistics normalize as in training,
    but the running statistics stay as the first forward left them."""

    synced = False
    sync_group = None
    keep_running_stats = False

    def __init__(self, features: int, eps: float = 1e-5, decay: float = 0.9):
        super().__init__()
        self.eps = eps
        self.decay = decay
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            if self.synced:
                var, mean, n = global_var_mean(xf, self.sync_group)
            else:
                axes = tuple(range(x.dim() - 1))
                var, mean = torch.var_mean(xf, dim=axes, correction=0)
                n = x.numel() // x.shape[-1]
            if not self.keep_running_stats:
                self._update_running(mean, var, n)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias

    @torch.no_grad()
    def _update_running(self, mean, var, n) -> None:
        """Move the running statistics towards the batch mean and the
        unbiased batch variance (``n``: the count, a tensor when it is the
        global batch's)."""
        self.running_mean.mul_(self.decay).add_(mean, alpha=1.0 - self.decay)
        if torch.is_tensor(n):
            self.running_var.mul_(self.decay).add_(
                var * (n / (n - 1).clamp(min=1)) * (1.0 - self.decay))
        else:
            self.running_var.mul_(self.decay).add_(
                var, alpha=(1.0 - self.decay) * (n / max(n - 1, 1)))


class _SumOverRanks(torch.autograd.Function):
    """``all_reduce`` (sum) over ``group`` whose backward sums the incoming
    gradients over the ranks as well: each rank's loss depends on every
    rank's contribution to the sum."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed as dist

        ctx.group = group
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def global_var_mean(xf: torch.Tensor, group=None):
    """``(biased var, mean, count)`` per channel (last dim) of ``xf`` over
    its leading dims on every rank of ``group``, in two passes as
    ``torch.var_mean`` computes them: all-reduce the sums and counts for
    the global mean, then the centred sums of squares (one pass, E[x²] −
    E[x]², cancels in f32 on channels whose mean is large against their
    spread).  The reductions are differentiable: the gradient of a
    global-batch statistic reaches every rank's activations, as the
    JAX package's step differentiates through its cross-process sum."""
    axes = tuple(range(xf.dim() - 1))
    c = xf.shape[-1]
    n_local = xf.new_full((1,), xf.numel() // c)
    sums = _SumOverRanks.apply(torch.cat([xf.sum(axes), n_local]), group)
    n = sums[c:].detach()
    mean = sums[:c] / n
    var = _SumOverRanks.apply(((xf - mean) ** 2).sum(axes), group) / n
    return var, mean, n


def rematerialize(fn: nn.Module, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant): the
    activations inside ``fn`` are dropped after the forward and recomputed
    in the backward pass, compute traded for memory (the JAX package's
    ``nn.remat``).

    The recomputation must not move BatchNorm's running statistics a second
    time (flax takes them from the forward's returned state alone): it runs
    with ``keep_running_stats`` set on every ``TorchBatchNorm`` of ``fn``,
    which normalize with the same batch statistics as the first forward
    (same input, same sums), so the gradients are unchanged.  Under data
    parallelism the recomputation repeats :func:`global_var_mean`'s
    all-reduces (and a model-sharded layer's gather): every rank runs the
    same backward graph, in order on one device thread, so the ranks
    recompute the same stages in the same order and the collectives pair
    up."""
    from torch.utils.checkpoint import checkpoint

    bns = [m for m in fn.modules() if isinstance(m, TorchBatchNorm)]

    @contextlib.contextmanager
    def recomputing():
        for m in bns:
            m.keep_running_stats = True
        try:
            yield
        finally:
            for m in bns:
                m.keep_running_stats = False

    return checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), recomputing()))


def apply_layer(layer: nn.Module, x: torch.Tensor,
                op: Callable, dtype: torch.dtype,
                with_bias: bool = True) -> torch.Tensor:
    """``op(x, weight, bias)`` with ``layer``'s weight and bias cast to
    ``dtype``; ``op``'s output carries the layer's channels last.  With
    ``with_bias`` False the bias is left out (``op`` gets None): the caller
    adds it itself.

    A layer whose output channels are sharded over the mesh's model axis
    (``layer.model_shard``, set by ``parallel/mesh.py::shard_model``) holds
    only its rank's slice of the weight: ``x`` enters through the shard's
    identity (whose backward sums the input gradient over the model group),
    ``op`` runs on the slice without bias, the slices are gathered along
    the last axis (whose backward keeps the rank's slice of the gradient),
    then the full bias, replicated on every rank, is added: its gradient is
    the same on every rank of the model group."""
    w = layer.weight.to(dtype)
    b = None if layer.bias is None or not with_bias else layer.bias.to(dtype)
    shard = getattr(layer, "model_shard", None)
    if shard is None:
        return op(x, w, b)
    y = shard.gather(op(shard.enter(x), w, None))
    return y if b is None else y + b


def _conv_init_(conv: nn.Conv2d, generator: torch.Generator) -> None:
    """PyTorch's default Conv2d init (kaiming-uniform, a=sqrt(5)), drawn
    from ``generator``."""
    fan_in = conv.weight[0].numel()
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        conv.weight.uniform_(-bound, bound, generator=generator)
        if conv.bias is not None:
            conv.bias.uniform_(-bound, bound, generator=generator)


def same_padding(n: int, k: int, stride: int):
    """(low, high) padding of one spatial dim of size ``n`` under XLA's
    ``"SAME"``: ``ceil(n / stride)`` outputs, total
    ``max((ceil(n / stride) - 1) * stride + k - n, 0)``, the low side
    ``total // 2`` and the high side the rest.  A 3x3 stride-2 conv on an
    even size pads ``(0, 1)``, not one row on each side."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


class ConvBnLeaky(nn.Module):
    """Conv + BatchNorm + LeakyReLU(0.1), NHWC in and out; with
    ``activation="mish"`` conv + BatchNorm + Mish (``x * tanh(softplus(x))``,
    ``F.mish``), YOLOv4's CBM block.

    The conv keeps its bias, like the JAX package and the reference.  The
    conv runs in ``dtype``; BN, the activation and the cast back to
    ``dtype`` follow in float32.  ``padding`` is ``"SAME"`` (XLA's rule,
    :func:`same_padding`, asymmetric at stride 2), ``"VALID"``, or
    ``"SYMMETRIC"`` (Darknet's: ``k // 2`` on every side at every stride,
    inside cuDNN's conv, no padded copy).

    ``int8_dynamic`` (inference only, ignored in training mode): a 3x3
    conv with at least 128 input channels runs as the JAX package's
    dynamic int8 conv (``odc_tpu/models/layers.py::ConvBnLeaky``): the input
    quantized per tensor over the whole batch, the weights per output
    channel, the int32 sums from ``ops/quantize.py::conv_i8`` (the
    hand-written GEMM on a CUDA tensor), ``acc * (sx * sw) + bias`` in
    float32, then this block's own BN (running statistics), leaky and the
    cast to ``dtype``.  The same parameters serve both precisions.

    On a mesh with a model axis the conv of a block with at least 512
    outputs keeps only its rank's output channels (:func:`apply_layer`);
    BN and leaky run on the gathered, replicated map.

    Inference in bf16 on the card (:meth:`_fuses_epilogue`): the conv runs
    without its bias, and the bias add, BN, the activation and the cast run
    as one hand-written kernel (``ops/cuda/bias_bn_leaky_kernel.py``,
    ``ops/cuda/bias_bn_mish_kernel.py``), bitwise equal to the separate
    passes.  Training, the CPU, other dtypes, a sharded conv and the int8
    conv keep the separate passes.  The span around the epilogue is
    ``bn_leaky`` for a leaky block and ``bn_mish`` for a Mish block."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel: int = 3,
        negative_slope: float = 0.1,
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
        stride: int = 1,
        padding: str = "SAME",
        int8_dynamic: bool = False,
        activation: str = "leaky",
    ):
        super().__init__()
        if padding not in ("SAME", "VALID", "SYMMETRIC"):
            raise ValueError(f"padding must be 'SAME', 'VALID' or "
                             f"'SYMMETRIC', got {padding!r}")
        if activation not in ("leaky", "mish"):
            raise ValueError(f"activation must be 'leaky' or 'mish', got "
                             f"{activation!r}")
        self.dtype = dtype
        self.negative_slope = negative_slope
        self.activation = activation
        self.stride = stride
        self.padding = padding
        self.int8_dynamic = int8_dynamic
        # SYMMETRIC and stride 1 SAME (odd kernels) stay in the conv; other
        # SAME cases pad the NHWC map explicitly in forward.
        symmetric = padding == "SYMMETRIC" or (
            padding == "SAME" and stride == 1 and kernel % 2 == 1)
        self.pad_input = padding == "SAME" and not symmetric
        self.conv = nn.Conv2d(
            in_features, features, kernel, stride=stride,
            padding=kernel // 2 if symmetric else 0, bias=True,
        )
        # The forward goes through apply_layer: the conv may be sharded
        # over the mesh's model axis (parallel/mesh.py::shard_model).
        self.conv.model_shardable = True
        if generator is not None:
            _conv_init_(self.conv, generator)
        self.bn = TorchBatchNorm(features)

    def pads(self, h: int, w: int):
        """((top, bottom), (left, right)) padding of an ``h`` x ``w``
        input."""
        k = self.conv.kernel_size[0]
        if self.padding == "VALID":
            return (0, 0), (0, 0)
        if self.padding == "SYMMETRIC":
            return (k // 2, k // 2), (k // 2, k // 2)
        return (same_padding(h, k, self.stride),
                same_padding(w, k, self.stride))

    def _uses_int8(self, x: torch.Tensor) -> bool:
        return (self.int8_dynamic and not self.training
                and self.conv.kernel_size == (3, 3) and x.shape[-1] >= 128)

    def _fuses_epilogue(self, x: torch.Tensor) -> bool:
        """Whether the bias, BN, the activation and the cast run as one
        kernel: an eval-mode bf16 block on a CUDA input whose conv is
        neither sharded nor int8."""
        return (not self.training and x.is_cuda
                and self.dtype == torch.bfloat16
                and getattr(self.conv, "model_shard", None) is None
                and not self._uses_int8(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        fused = self._fuses_epilogue(x)
        with span("conv"):
            if self._uses_int8(x):
                y = self._int8_conv(x)
            else:
                h = x.to(dt)
                if self.pad_input:
                    (t, b), (l, r) = self.pads(*h.shape[1:3])
                    h = F.pad(h, (0, 0, l, r, t, b))
                y = apply_layer(self.conv, h, self._conv_nhwc, dt,
                                with_bias=not fused)
        if self.activation == "mish":
            return self._bn_mish(y, fused)
        with span("bn_leaky"):
            if fused:
                from odc_tpu_torch.ops.cuda.bias_bn_leaky_kernel import (
                    bias_bn_leaky,
                )

                count("fused_epilogue")
                bn = self.bn
                return bias_bn_leaky(
                    y.contiguous(), self.conv.bias, bn.running_mean,
                    bn.running_var, bn.weight, bn.bias, bn.eps,
                    self.negative_slope)
            y = self.bn(y)
            return F.leaky_relu(y, self.negative_slope).to(dt)

    def _bn_mish(self, y: torch.Tensor, fused: bool) -> torch.Tensor:
        """BN, Mish and the cast of a Mish block's conv output ``y`` (without
        its bias on the fused route)."""
        with span("bn_mish"):
            if fused:
                from odc_tpu_torch.ops.cuda.bias_bn_mish_kernel import (
                    bias_bn_mish,
                )

                count("fused_epilogue")
                bn = self.bn
                return bias_bn_mish(
                    y.contiguous(), self.conv.bias, bn.running_mean,
                    bn.running_var, bn.weight, bn.bias, bn.eps)
            return F.mish(self.bn(y)).to(self.dtype)

    def _conv_nhwc(self, h, w, b):
        return F.conv2d(h.permute(0, 3, 1, 2), w, b, stride=self.stride,
                        padding=self.conv.padding).permute(0, 2, 3, 1)

    @torch.no_grad()
    def _int8_conv(self, x: torch.Tensor) -> torch.Tensor:
        from odc_tpu_torch.ops.quantize import (
            conv_i8, hwio, quantize_dynamic, quantize_weights_per_channel,
        )

        if getattr(self.conv, "model_shard", None) is not None:
            raise ValueError("int8_dynamic runs on unsharded models only "
                             "(this conv's weight is sharded over the "
                             "model axis)")

        xq, sx = quantize_dynamic(x)
        wq, sw = quantize_weights_per_channel(hwio(self.conv.weight))
        acc = conv_i8(xq, wq, stride=self.stride,
                      pads=self.pads(*x.shape[1:3]))
        return acc.float() * (sx * sw) + self.conv.bias.float()


class Residual(nn.Module):
    """``x + expand(reduce(x))``: a 1x1 ``ConvBnLeaky`` to ``mid`` channels,
    then a 3x3 back to ``width`` (Darknet-53's bottleneck, the reference's
    ConvAndResidualLayer; CSPDarknet53's residual block).  ``kw`` reaches
    both convs."""

    def __init__(self, width: int, mid: int, **kw):
        super().__init__()
        self.reduce = ConvBnLeaky(width, mid, 1, **kw)
        self.expand = ConvBnLeaky(mid, width, 3, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.expand(self.reduce(x)) + x


def extent_mask(shape, eh: torch.Tensor, ew: torch.Tensor) -> torch.Tensor:
    """Per-image valid-extent mask for a padded NHWC batch.

    ``shape`` is the [B, H, W, C] batch shape, ``eh``/``ew`` the [B] valid
    extents (rows/cols below the extent are valid).  Returns a
    [B, H, W, 1] bool mask, True inside each image's valid region.

    Zeroing beyond the extents before every k > 1 conv makes a padded
    forward equal, up to summation order, to running each image at its
    native size with SAME zero padding: border windows read zeros where the
    native run's implicit padding would be, and floor-halving the extents at
    each pool reproduces the native run's odd-dimension drops."""
    _, h, w, _ = shape
    rm = torch.arange(h, device=eh.device)[None, :] < eh[:, None]
    cm = torch.arange(w, device=ew.device)[None, :] < ew[:, None]
    return (rm[:, :, None] & cm[:, None, :])[..., None]


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max pool of an NHWC map, floor semantics (odd rows/cols drop)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def max_pool_3x3_ceil(x: torch.Tensor) -> torch.Tensor:
    """3x3/2 max pool of an NHWC map, ``ceil_mode=True`` (torchvision
    GoogLeNet's pools): the JAX package's ``(0, 1)`` -inf padding, so an
    odd trailing row/col gets a window of its own."""
    return F.max_pool2d(
        x.permute(0, 3, 1, 2), 3, 2, ceil_mode=True
    ).permute(0, 2, 3, 1)


def max_pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k / 1 max pool of an NHWC map, ``-inf`` padding ``k // 2`` (SAME
    at an odd ``k``): Inception branch 4's 3x3, YOLOv4's SPP pools."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, 1, padding=k // 2).permute(
        0, 2, 3, 1)
