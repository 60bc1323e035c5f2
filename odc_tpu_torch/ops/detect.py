"""End-to-end batched inference: uint8 images -> NMS'd boxes, on the card.

Port of ``odc_tpu/ops/detect.py::make_infer_fn``.  One deliberate routing
difference from the JAX package's default: on a Darknet-19 backbone (a
YOLOv2), stages 1-2 run as the fused superstem kernel
(``ops/cuda/superstem_kernel.py``), with the BN folded into its weights
once, when the function is built.  It
computes the same function as the unfused stem within bf16 rounding.  A
YOLOv1 runs its own forward (GoogLeNet, then the Dense head, whose f32
weights are cast to the compute dtype at every call, as flax does).  A
YOLOv3 runs its own forward too (Darknet-53, the FPN, three heads, decoded
into one flat box axis of 10647 candidates an image at 416x416); built with
``int8_dynamic``, its 32 wide 3x3 convs run as int8 GEMMs of the
hand-written kernel.  A YOLOv4 runs its own forward (CSPDarknet53, SPP,
PANet; 22743 candidates an image at 608x608), bf16 only.  The suppression is one NMS kernel launch for the
whole batch.

On a card, a bf16 call whose batch shape and thresholds were seen before
replays a CUDA graph of the whole call (forward, decode, NMS and the
outputs) in place of issuing its operations one by one: the host, not
the card, set the pace of such calls.  The replay runs the same
kernels on the same data, so its outputs are bitwise the eager call's.
A function whose calls keep changing shape or threshold (the evaluator's
native-size YOLOv2) stops capturing after ``GRAPH_KEYS`` of them.

The int8 arguments follow the JAX package: ``int8_scales`` runs the full
int8 PTQ engine (``ops/int8_engine.py``) in place of the model forward and
the fused stem, 20 launches of the GEMM kernel a call; ``int8_neck`` keeps
the fused stem and swaps the 3x3 neck conv for the dynamic-PTQ int8 conv
(``ops/quantize.py``), one GEMM launch a call.

``make_native_infer_fn`` is the native-size counterpart over batches padded
to a common bucket (the JAX package's evaluation semantics): the masked
forward, bf16 or the int8 engine, then decode and one NMS kernel launch.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.nn.modules import module as _nn_module

from odc_tpu_torch.core.nms import class_offset_boxes, nms_padded
from odc_tpu_torch.models.backbones.darknet19 import Darknet19Backbone
from odc_tpu_torch.ops.cuda import build
from odc_tpu_torch.ops.cuda.superstem_kernel import fold_weights, superstem
from odc_tpu_torch.ops.int8_engine import scales_tensor, yolov2_int8_forward
from odc_tpu_torch.ops.quantize import int8_conv_bn_leaky
from odc_tpu_torch.parallel.mesh import model_shards
from odc_tpu_torch.utils.metrics import count, profiling, span

# The keys (batch shape, image dtype, thresholds) an inference function may
# capture.  At a key beyond them its calls vary too much for a capture to
# pay back (each costs a device sync, a garbage collection and a graph
# held for good), so it drops its graphs and runs eagerly from then on.
GRAPH_KEYS = 4


def nms_outputs(boxes, conf, cls_spec, conf_thre, iou_thre, max_keep: int,
                class_wise: bool, compact: bool = True):
    """The tail of both inference functions: ``boxes`` [B, N, 4] and
    ``conf`` [B, N] of the flat candidates, ``cls_spec`` their class scores
    in any shape ending in the classes.  With ``class_wise`` boxes of other
    argmax classes never suppress each other (``class_offset_boxes``); one
    ``nms_padded`` launch; ``compact`` turns its outputs into ``(boxes,
    conf, labels int32, label_scores, keep)``."""
    b, num_cls = boxes.shape[0], cls_spec.shape[-1]
    cls_scores = cls_spec.reshape(b, -1, num_cls)
    sup = (class_offset_boxes(boxes, cls_scores.argmax(-1)) if class_wise
           else None)
    out = nms_padded(boxes, conf, cls_scores, conf_thre, iou_thre, max_keep,
                     suppress_boxes=sup)
    if not compact:
        return out
    o_boxes, o_conf, o_cls, o_keep = out
    return (o_boxes, o_conf, o_cls.argmax(-1).to(torch.int32),
            o_cls.max(-1).values, o_keep)


def stem_weights(model):
    """Folded superstem weights ``(w1, w2)`` of a YOLOv2's stages 1-2, in
    the model's compute dtype, on its device."""
    blocks = [model.backbone.stages[0][0], model.backbone.stages[1][0]]
    args = []
    for blk in blocks:
        args += [
            blk.conv.weight, blk.conv.bias, blk.bn.weight, blk.bn.bias,
            blk.bn.running_mean, blk.bn.running_var,
        ]
    with torch.no_grad():
        return fold_weights(*args, eps=blocks[0].bn.eps, dtype=model.dtype)


def make_infer_fn(
    model,
    conf_thre: float = 0.9,
    iou_thre: float = 0.5,
    max_keep: int = 64,
    class_wise: bool = False,
    int8_neck: bool = False,
    int8_scales=None,
    int8_stem: str = "s2d",
    compact: bool = False,
) -> Callable:
    """Build ``infer(images, conf_thre=..., iou_thre=...)`` for a YOLOv1, a
    YOLOv2, a YOLOv3 or a YOLOv4.

    ``images`` is [B, H, W, 3] uint8 (moved to the model's device).  Returns
    ``(boxes [B, max_keep, 4], conf [B, max_keep], cls_scores
    [B, max_keep, C], keep [B, max_keep])``, or with ``compact``
    ``(boxes, conf, labels int32, label_scores, keep)``.  The thresholds
    are runtime arguments, floats or 0-d float32 CPU tensors (what
    ``serve/engine.py`` passes, so ``torch.export`` keeps them as inputs);
    ``max_keep`` is fixed.  ``class_wise`` runs
    per-class suppression.  The model is put in eval mode and a YOLOv2's
    stem weights are folded now: later weight changes need a new function.

    ``int8_scales`` (a [22, 2] range matrix from
    ``ops/int8_engine.py::calibrate``, tensor or numpy): run the full int8
    PTQ engine with the ``int8_stem`` formulation (``"s2d"``, ``"plain"``
    or ``"s2d2"``) instead of the model forward.  ``int8_neck``: the 3x3
    neck conv runs as the dynamic-PTQ int8 conv.  Both need a quadrant-neck
    YOLOv2 (a YOLOv3 has no neck: its int8 is the model's own
    ``int8_dynamic``).

    CUDA graphs.  A bf16 model on a card (neither int8 argument, not a
    YOLOv3 built with ``int8_dynamic``, no conv sharded over a model axis)
    replays a CUDA graph of the whole call for a key of (batch shape, image
    dtype, ``float(conf_thre)``, ``float(iou_thre)``) it has seen twice:
    the key's first call runs eagerly (the warm-up), its second captures
    the call and replays it, later ones copy the images into the graph's
    input and replay.  Every call returns fresh tensors.  At its
    ``GRAPH_KEYS + 1``-th key the function drops its graphs and runs every
    later call eagerly: calls that keep changing shape or threshold, as
    ``eval/evaluator.py::Detector.detect`` makes at each image's own size,
    stay eager after a few captures.  The call runs eagerly, exactly as
    without graphs, while a ``torch.profiler`` records (so every span,
    module hook and counter of a traced run fires), under ``torch.compile``
    or ``torch.export``, inside another stream capture, and while any
    module of the model has a forward hook.  A sharded model stays eager:
    its forward gathers over the process group.  A replay runs what was
    captured: a kernel route patched afterwards is not seen (build a new
    function).  The graphs share one memory pool and one input buffer per
    batch shape; run a function from one thread and stream at a time.
    ``infer.graphing`` says whether the function may still capture or
    replay; ``infer.graph_captures`` and ``infer.graph_replays`` count
    captures and replays (the capturing call's own run is not a replay);
    each replay adds its graph's launches to every counting kernel's
    ``.launches`` (``ops/cuda/build.py::COUNTED``)."""
    if int8_scales is not None or int8_neck:
        # The int8 paths hardcode the Darknet-19/quadrant YOLOv2 graph; a
        # space_to_depth model would silently run the quadrant reorg and
        # produce wrong boxes.
        neck = getattr(model, "neck_kind", None)
        if type(model).__name__ != "YOLOv2" or neck != "quadrant":
            raise ValueError(
                "int8_scales/int8_neck require a YOLOv2 with neck='quadrant' "
                f"(got {type(model).__name__}, neck={neck!r})"
            )
    model.eval()
    device = next(model.parameters()).device
    # The superstem computes Darknet-19's stages 1-2 and a forward that
    # takes ``stem_out`` runs the rest: a capability of the backbone.
    fused_stem = int8_scales is None and isinstance(
        getattr(model, "backbone", None), Darknet19Backbone)
    if int8_scales is not None:
        int8_scales = scales_tensor(int8_scales, device)
    elif fused_stem:
        w1, w2 = stem_weights(model)

    def int8_neck_conv(h):
        return int8_conv_bn_leaky(h, model.neck, out_dtype=model.dtype)

    def forward(images):
        if int8_scales is not None:
            return yolov2_int8_forward(
                model, images, scales=int8_scales,
                num_anchor_box=model.num_anchor_box, num_cls=model.num_cls,
                stem=int8_stem,
            )
        if not fused_stem:
            return model(images)
        return model(images, stem_out=superstem(images, w1, w2),
                     neck_override=int8_neck_conv if int8_neck else None)

    def run(images, conf_thre, iou_thre):
        y = forward(images)
        with span("decode"):
            det = model.decode(y, images.shape[1:3])
        with span("nms"):
            b = images.shape[0]
            return nms_outputs(
                det.boxes.reshape(b, -1, 4), det.conf.reshape(b, -1),
                det.cls_spec, conf_thre, iou_thre, max_keep, class_wise,
                compact)

    graphable = (device.type == "cuda" and int8_scales is None
                 and not int8_neck and model.dtype == torch.bfloat16
                 and not getattr(model, "int8_dynamic", False)
                 and not model_shards(model))
    hook_dicts = [d for m in model.modules()
                  for d in (m._forward_hooks, m._forward_pre_hooks)]
    graphs = {}  # key -> _Graph, or None once seen
    inputs = {}  # (shape, dtype) -> the graphs' input buffer
    pool = torch.cuda.graph_pool_handle() if graphable else None

    def eager_only() -> bool:
        return (profiling() or torch.compiler.is_compiling()
                or torch.cuda.is_current_stream_capturing()
                or any(hook_dicts) or bool(_nn_module._global_forward_hooks)
                or bool(_nn_module._global_forward_pre_hooks))

    def graphed(images, conf_thre, iou_thre):
        """The call's outputs from a graph, or None for an eager call."""
        conf_thre, iou_thre = float(conf_thre), float(iou_thre)
        key = (tuple(images.shape), images.dtype, conf_thre, iou_thre)
        if key not in graphs:
            if len(graphs) == GRAPH_KEYS:  # the calls vary: eager for good
                infer.graphing = False
                graphs.clear()
                inputs.clear()
            else:  # the key's warm-up: eager
                graphs[key] = None
            return None
        g = graphs[key]
        if g is None:
            static = inputs.get(key[:2])
            if static is None:
                static = inputs[key[:2]] = torch.empty_like(images)
            static.copy_(images)
            g = graphs[key] = _Graph.capture(
                lambda: run(static, conf_thre, iou_thre), pool)
            infer.graph_captures += 1
        else:
            inputs[key[:2]].copy_(images)
            g.count_launches()
            infer.graph_replays += 1
        g.graph.replay()
        return tuple(o.clone() for o in g.outputs)

    @torch.no_grad()
    def infer(images, conf_thre=conf_thre, iou_thre=iou_thre):
        with span("infer"):
            images = torch.as_tensor(images, device=device)
            count("images", images.shape[0])
            if infer.graphing and not eager_only():
                out = graphed(images, conf_thre, iou_thre)
                if out is not None:
                    return out
            return run(images, conf_thre, iou_thre)

    infer.graphing = graphable
    infer.graph_captures = infer.graph_replays = 0
    return infer


class _Graph:
    """One captured call: the CUDA graph, its output tensors, and the
    launches of each hand-written kernel it holds."""

    def __init__(self, graph, outputs, launches):
        self.graph, self.outputs, self.launches = graph, outputs, launches

    @classmethod
    def capture(cls, fn, pool) -> "_Graph":
        """Capture ``fn()`` (its tensors in ``pool``); nothing runs yet."""
        before = [k.launches for k in build.COUNTED]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=pool,
                              capture_error_mode="thread_local"):
            outputs = fn()
        launches = [(k, k.launches - n)
                    for k, n in zip(build.COUNTED, before)
                    if k.launches != n]
        return cls(graph, outputs, launches)

    def count_launches(self) -> None:
        for kernel, n in self.launches:
            kernel.launches += n


def make_native_infer_fn(
    model,
    conf_thre: float = 0.9,
    iou_thre: float = 0.5,
    max_keep: int = 64,
    class_wise: bool = False,
    int8_scales=None,
    int8_stem: str = "s2d",
) -> Callable:
    """Native-size inference over a PADDED batch, YOLOv2 only.

    ``infer(images, valid_hw, conf_thre=..., iou_thre=...)``: ``images``
    [B, H, W, 3] uint8 padded top-left with zeros to a common bucket,
    ``valid_hw`` [B, 2] each image's native (h, w) (numpy or a tensor;
    moved to the model's device once per call).  The masked forward
    (``YOLOv2.forward(valid_hw=...)``, or the int8 engine's with
    ``int8_scales``) makes each image's valid grid cells equal its
    native-size run; decode works in grid units and scales each image by
    its native cell size (``valid_hw / (valid_hw // 32)``), so boxes come
    out in native pixels; cells beyond an image's grid get conf 0 (so
    ``conf_thre`` must be > 0).  The suppression is one NMS kernel launch
    for the batch.  Returns the compact outputs ``(boxes, conf, labels
    int32, label_scores, keep)``.

    The fused superstem does not serve this path: it has no extents, and
    ``valid_hw`` excludes ``stem_out``.  Stages 1-2 run as masked cuDNN
    convolutions, as the JAX package runs its XLA stem here."""
    if type(model).__name__ != "YOLOv2":
        raise ValueError("make_native_infer_fn supports YOLOv2 only "
                         "(v1 resizes to the network size; use make_infer_fn)")
    if int8_scales is not None and model.neck_kind != "quadrant":
        raise ValueError(
            "int8_scales require a YOLOv2 with neck='quadrant' (the engine "
            f"hardcodes the quadrant graph; got neck={model.neck_kind!r})"
        )
    model.eval()
    device = next(model.parameters()).device
    if int8_scales is not None:
        int8_scales = scales_tensor(int8_scales, device)

    @torch.no_grad()
    def infer(images, valid_hw, conf_thre=conf_thre, iou_thre=iou_thre):
        with span("infer"):
            images = torch.as_tensor(images, device=device)
            count("images", images.shape[0])
            if not torch.is_tensor(valid_hw) or valid_hw.device != device:
                with span("sync", site="valid_hw"):
                    valid_hw = torch.as_tensor(valid_hw, device=device)
            valid_hw = valid_hw.long()
            if int8_scales is not None:
                y = yolov2_int8_forward(
                    model, images, scales=int8_scales,
                    num_anchor_box=model.num_anchor_box,
                    num_cls=model.num_cls, stem=int8_stem, valid_hw=valid_hw,
                )
            else:
                y = model(images, valid_hw=valid_hw)
            with span("decode"):
                det = model.decode(y, y.shape[1:3])  # grid units: cell 1
            with span("nms"):
                return native_nms_outputs(det, valid_hw, conf_thre, iou_thre)

    def native_nms_outputs(det, valid_hw, conf_thre, iou_thre):
        b, hg, wg = det.conf.shape[:3]
        gh, gw = valid_hw[:, 0] // 32, valid_hw[:, 1] // 32
        dt = det.boxes.dtype
        sx = (valid_hw[:, 1] / gw).to(dt)  # native cell width
        sy = (valid_hw[:, 0] / gh).to(dt)
        scale = torch.stack([sx, sy, sx, sy], -1)[:, None, None, None, :]
        boxes = (det.boxes * scale).reshape(b, -1, 4)
        rows = torch.arange(hg, device=device)[None, :] < gh[:, None]
        cols = torch.arange(wg, device=device)[None, :] < gw[:, None]
        cell_valid = rows[:, :, None] & cols[:, None, :]  # [B, Hg, Wg]
        conf = torch.where(cell_valid[..., None], det.conf, 0.0).reshape(b, -1)
        return nms_outputs(boxes, conf, det.cls_spec, conf_thre, iou_thre,
                           max_keep, class_wise)

    return infer
