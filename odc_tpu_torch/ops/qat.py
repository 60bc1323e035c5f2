"""Quantization-aware fine-tuning (QAT) for the int8 PTQ engine.

Port of ``odc_tpu/ops/qat.py``, function for function.  The forward is the
float *twin* of :func:`odc_tpu_torch.ops.int8_engine.yolov2_int8_forward`:
every tensor the engine quantizes round-trips through the engine's own int8
codes (*fake quantization*), and the straight-through estimator (STE)
passes gradients through the round and clip, so SGD pulls the weights
towards values that survive quantization:

* weights fake-quantize with the engine's symmetric per-output-channel
  scheme (``amax / 127``, the same clip); the scale is a constant of the
  step, the codes get the STE;
* activations fake-quantize with the engine's static calibrated asymmetric
  per-tensor codes (``(pos + neg) / 255``, the same zero point) at the
  same requant points, the quadrant concat's included;
* BatchNorm reads the frozen running statistics, as the engine folds them
  (QAT fine-tunes a trained checkpoint; the step never calls
  ``model.train()``, and BN scale and bias keep training);
* the head stays float, with the engine's bf16 roundings.

With ``exact=True`` (the fine-tune default) the forward VALUE is the
deployed engine itself, bit for bit, and the gradient is the twin's
(:class:`_ValueOfGradOf`): QAT trains the program being deployed.

Rounding is half to even on both sides (``torch.round``, ``jnp.round``).
The STE's value is ``x + (q - x).detach()``, computed in that order: it
rounds once in f32, exactly as JAX's ``x + stop_gradient(q - x)``, and is
not always ``q`` itself.

On the card cuDNN runs f32 convolutions in TF32 unless told otherwise,
which would flip fake-quant codes; the twin and the QAT step run their
convolutions in IEEE f32 (:func:`ieee_f32_convs`, a local switch that
restores the caller's settings).

The augmentation inside the step draws from the step's
``torch.Generator``, as ``train/trainer.py::make_train_step`` does; its
draws cannot match JAX's ``jax.random`` keys, so cross-framework tests
replay parameters or run without augmentation.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from odc_tpu_torch.models.layers import IMAGENET_MEAN, IMAGENET_STD
from odc_tpu_torch.models.yolov2 import quadrant_stack
from odc_tpu_torch.ops.int8_engine import (
    _INPUT_AMAX,
    _LAST_OF_STAGE,
    _STAGE_OF,
    _act_qparams,
    _blocks,
    _conv_f32,
    _float_epilogue,
    _pool,
    scales_tensor,
    yolov2_int8_forward,
)
from odc_tpu_torch.ops.quantize import hwio


@contextlib.contextmanager
def ieee_f32_convs():
    """cuDNN convolutions in IEEE f32 (no TF32) inside the block; the
    caller's other cuDNN settings are kept and everything is restored on
    exit.  Without it a card computes the twin's f32 convolutions of
    fake-quantized values in TF32 (10-bit mantissas), which flips codes and
    moves calibrated ranges by about 1e-3."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        yield


def _ste(x, q):
    """Straight-through estimator: forward ``q`` (as ``x + (q - x)``, one
    f32 rounding, JAX's ``x + stop_gradient(q - x)``), backward identity."""
    return x + (q - x).detach()


class _ValueOfGradOf(torch.autograd.Function):
    """Forward: ``value`` BITWISE (no float round trip, unlike
    ``x + (q - x).detach()``).  Backward: the cotangent flows to
    ``grad_path``, nothing to ``value``.  The exact-mode outer STE."""

    @staticmethod
    def forward(ctx, value, grad_path):
        return value.clone()

    @staticmethod
    def backward(ctx, g):
        return None, g


def fake_quant_weight(kernel, eps: float = 1e-8):
    """Engine-exact symmetric per-out-channel fake quantization of an HWIO
    ``kernel``: the scale ``amax / 127`` of
    ``ops/quantize.py::quantize_weights_per_channel`` (``amax`` over axes
    0-2, detached), codes clipped to [-127, 127] with the STE."""
    k = kernel.float()
    amax = k.detach().abs().amax(dim=(0, 1, 2)).clamp_min(eps)
    s = amax / 127.0
    q = torch.clamp(torch.round(k / s), -127, 127) * s
    return _ste(k, q)


def fake_quant_act(y, stat_row):
    """Engine-exact asymmetric per-tensor activation fake quantization.

    ``stat_row`` is one calibrated ``[pos_max, neg_max]`` row of the
    :func:`odc_tpu_torch.ops.int8_engine.calibrate` matrix; codes map
    ``[-neg, pos]`` onto the full int8 range with the engine's zero
    point."""
    s, z = _act_qparams(stat_row)
    q = torch.clamp(torch.round(y / s + z), -128, 127)
    return _ste(y, (q - z) * s)


def _fake_quant_input(h0):
    """The plain-stem input quantization (symmetric, static scale)."""
    s = torch.tensor(_INPUT_AMAX / 127.0, dtype=torch.float32,
                     device=h0.device)
    q = torch.clamp(torch.round(h0 / s), -127, 127) * s
    return _ste(h0, q)


def _bf16(x):
    """Round through bf16 and back to f32; differentiable (the cotangent
    rounds through bf16 too, as under JAX's ``astype``)."""
    return x.to(torch.bfloat16).float()


def _twin_conv(shard, h, kernel):
    """The f32 conv of ``h`` with the fake-quantized ``kernel``, BEFORE the
    epilogue.  A block sharded over the mesh's model axis runs as
    ``models/layers.py::apply_layer``: ``h`` enters through the shard's
    identity (backward: the input gradient summed over the model group),
    the conv runs on the rank's kernel slice (its per-output-channel
    ``amax`` is the whole kernel's), and the slices are gathered along
    channels (backward: the rank's slice).  The replicated conv bias, BN,
    leaky and activation fake quantization come after the gather, on every
    rank alike, so their gradients are equal across the model group (cut to
    a slice, each rank would move them by its own channels and the ranks
    would drift apart).  The engine, which has no gradient, requantizes on
    the slice and gathers codes instead."""
    if shard is None:
        return _conv_f32(h, fake_quant_weight(kernel))
    return shard.gather(_conv_f32(shard.enter(h), fake_quant_weight(kernel)))


def yolov2_qat_forward(
    model,
    images,
    scales,
    num_anchor_box: int = 5,
    num_cls: int = 20,
    stem: str = "s2d",
    exact: bool = False,
    on_phase: Optional[Callable[[str], None]] = None,
):
    """Float twin of the int8 engine with fake quantization at every
    requant point, over the port's quadrant-neck
    :class:`~odc_tpu_torch.models.yolov2.YOLOv2` ``model``: its f32
    parameters (gradients reach them) and BN running statistics
    (constants).

    Args:
        images: [N, H, W, 3] RGB, uint8 or float in 0-255.
        scales: the [22, 2] calibration matrix (tensor or numpy array);
            STATIC: frozen during fine-tuning, shared verbatim with the
            deployed engine.
        stem: ``"s2d"`` (the ``make_infer_fn`` default: conv0 runs on
            bf16-rounded inputs and weights, its output quantizes at
            ``scales[0]``) or ``"plain"`` (the input and conv0's weights
            quantize too).  The engine's own default is ``"plain"``, so
            exact mode passes ``stem`` to it explicitly.
        exact: the forward VALUE is :func:`yolov2_int8_forward` itself, bit
            for bit (run under ``no_grad``), while gradients flow through
            the twin.  Costs an engine forward.
        on_phase: measurement only; called with ``"twin"`` once the twin is
            enqueued and, in exact mode, ``"engine"`` after the engine.

    On the mesh's model axis (a model after ``parallel.shard_model``) the
    sharded blocks run on the rank's output channels (:func:`_twin_conv`)
    and exact mode runs the sharded engine; every rank of the model group
    calls with the same images and gets the same head.
    Returns:
        Raw head [N, Hg, Wg, A, 5 + C] f32 (the engine's contract).
    """
    blocks = _blocks(model)
    device = images.device
    scales = scales_tensor(scales, device)
    if tuple(scales.shape) != (len(blocks) + 1, 2):
        raise ValueError(
            f"scales must have shape ({len(blocks) + 1}, 2), got "
            f"{tuple(scales.shape)}"
        )
    if stem not in ("plain", "s2d"):
        raise ValueError(f"stem must be 'plain' or 's2d', got {stem!r}")
    mark = on_phase or (lambda name: None)

    with ieee_f32_convs():
        mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device)
        std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device)
        h = (images.float() / 255.0 - mean) / std
        if stem == "plain":
            h = _fake_quant_input(h)

        c5 = None
        c5_idx = _LAST_OF_STAGE[4]
        for i, (conv_p, bn_p, bn_s, shard) in enumerate(blocks[:20]):
            si = _STAGE_OF[i]
            first_of_stage = i == 0 or _STAGE_OF[i - 1] != si
            if first_of_stage and 1 <= si <= 5:
                h = _pool(h)
            # conv0 under the s2d stem keeps FLOAT weights (the engine's
            # lifted 4x4/stride-2 conv is bf16): the twin rounds conv0's
            # inputs and weights through bf16 the same way, so the first
            # quantization sees the engine's values up to summation order.
            if i == 0 and stem == "s2d":
                y = _conv_f32(_bf16(h), _bf16(conv_p["kernel"]))
            else:
                y = _twin_conv(shard, h, conv_p["kernel"])
            h = fake_quant_act(_float_epilogue(y, conv_p, bn_p, bn_s),
                               scales[i])
            if i == c5_idx:
                c5 = h

        # The engine re-quantizes both sides of the quadrant concat to the
        # common concat scale; each side already sits on its own layer's
        # codes, so fake-quantizing the concatenated value reproduces that
        # code-to-code requant in value space.
        neck_in = fake_quant_act(torch.cat([quadrant_stack(c5), h], -1),
                                 scales[21])
        conv_p, bn_p, bn_s, shard = blocks[20]
        neck = _float_epilogue(_twin_conv(shard, neck_in, conv_p["kernel"]),
                               conv_p, bn_p, bn_s)

        # The head stays bf16 in the engine: bf16 operands with f32 sums,
        # then the engine's bf16 OUTPUT rounding before the f32 bias add
        # (JAX's bf16 conv has no preferred_element_type).
        head_w = _bf16(hwio(model.head.weight.float()))
        y = _bf16(_conv_f32(_bf16(neck), head_w)) + model.head.bias
        n, hg, wg, _ = y.shape
        y = y.reshape(n, hg, wg, num_anchor_box, 5 + num_cls)
    mark("twin")

    if exact:
        y_eng = yolov2_int8_forward(
            model, images, scales=scales, num_anchor_box=num_anchor_box,
            num_cls=num_cls, stem=stem,
        )
        mark("engine")
        y = _ValueOfGradOf.apply(y_eng, y)
    return y


def make_qat_train_step(
    model,
    lambdas,
    scales,
    anchors=None,
    momentum: float = 0.9,
    weight_decay: float = 5e-4,
    stem: str = "s2d",
    exact: bool = True,
    augment_cfg=None,
    augment_warp_impl: str = "auto",
    on_phase: Optional[Callable[[str], None]] = None,
    dp=None,
) -> Callable:
    """Build the QAT fine-tune step: ``(state, batch, lr, generator) ->
    (state, metrics)``, with the metric names of
    ``train/trainer.py::make_train_step``.

    The optimizer is the trainer's (``sgd_update``: torch-SGD with weight
    decay, in place), but the forward is :func:`yolov2_qat_forward` and the
    BN running statistics stay FROZEN.  With ``exact=True`` (default) the
    loss is evaluated on the DEPLOYED engine's output bit for bit.
    ``model`` supplies anchors and class count and must be the
    quadrant-neck YOLOv2 the engine supports; the step trains
    ``state.model``.  Every parameter gets a gradient: one the twin does
    not reach gets zeros (JAX's zero cotangent), never ``None``.

    ``augment_cfg``: in-step device augmentation drawing from
    ``generator``, targets re-assigned from the augmented boxes, as the
    trainer's step.  ``on_phase`` (measurement only): called with
    "augment", "twin", "engine" (exact mode), "loss", "backward" and
    "update" as each part has been enqueued.  ``dp`` (a
    ``parallel.DataParallel``): global-batch augmentation draws, global loss
    counts, gradients summed over the data axis and global metrics, as the
    trainer's step (BN is frozen here, so it reduces nothing).  On a model
    axis (``state.model`` sharded by ``parallel.shard_model``) the twin and
    the engine run sharded; each rank's gradients are its slices of the
    sharded kernels and the replicated parameters' whole gradients (model
    rank 0's, ``parallel.all_reduce_grads``)."""
    neck = getattr(model, "neck_kind", None)
    if type(model).__name__ != "YOLOv2" or neck != "quadrant":
        raise ValueError(
            "QAT mirrors the int8 engine, which hardcodes the quadrant-neck "
            f"YOLOv2 (got {type(model).__name__}, neck={neck!r})"
        )
    from odc_tpu_torch.ops.assign import assign
    from odc_tpu_torch.ops.augment import augment_batch
    from odc_tpu_torch.parallel.mesh import all_reduce_grads
    from odc_tpu_torch.train.trainer import (
        _loss, _targets_of, sgd_update, step_metrics,
    )

    anchors = anchors if anchors is not None else model.anchors
    mark = on_phase or (lambda name: None)
    scales = scales_tensor(scales, next(model.parameters()).device)

    def qat_step(state, batch, lr: float, generator=None):
        net = state.model
        image = batch.image
        targets = _targets_of(batch)
        if augment_cfg is not None:
            with torch.no_grad():
                image, boxes, valid = augment_batch(
                    generator, image, batch.box, batch.valid, augment_cfg,
                    warp_impl=augment_warp_impl, dp=dp,
                )
                targets = assign(
                    boxes, batch.cls, valid, tuple(image.shape[1:3]),
                    mode="v2",
                )
        mark("augment")

        net.zero_grad(set_to_none=True)
        with ieee_f32_convs():
            y = yolov2_qat_forward(
                net, image, scales, num_anchor_box=model.num_anchor_box,
                num_cls=model.num_cls, stem=stem, exact=exact,
                on_phase=mark,
            )
            loss, parts = _loss(model, "v2", y, tuple(image.shape[1:3]),
                                targets, lambdas, anchors, dp)
            mark("loss")
            loss.backward()
        mark("backward")
        for p in net.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if dp is not None:
            all_reduce_grads(net.parameters(), dp)
        sgd_update(state, float(lr), momentum, weight_decay)
        state.step += 1
        mark("update")
        return state, step_metrics(loss, parts, dp)

    return qat_step
