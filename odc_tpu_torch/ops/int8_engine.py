"""Full-int8 PTQ inference engine for YOLOv2.

Port of ``odc_tpu/ops/int8_engine.py``, function for function and op for op:

* **Weights**: symmetric per-output-channel int8, quantized on each call
  from the f32 parameters of the port's :class:`~odc_tpu_torch.models.yolov2.YOLOv2`.
* **Activations**: asymmetric per-tensor int8 with static ``(pos, neg)``
  ranges from a calibration pass (:func:`calibrate`): ``s = (pos+neg)/255``,
  zero point ``z = round(-128 + neg/s)``.  The convolutions pad with code 0;
  the zero point's interior term folds into the bias and its border term is
  a rank-1 correction of the accumulator.
* **BN folding**: each layer is ``conv(int8) -> int32 -> A[c]*acc + B[c] ->
  leaky -> round(y/s + z) -> clip -> int8``.
* **Pools** run on int8 (max commutes with the monotone requant).
* The quadrant passthrough and the backbone tap are re-quantized to the
  concat's range before the neck.

Every int8 convolution is ``ops/quantize.py::conv_i8``: im2col and the
hand-written GEMM kernel, exact int32.  The s2d stem's lifted conv and the
head stay float as in JAX: bf16 operands with f32 sums (an f32 convolution
of bf16-rounded tensors, which is that product exactly up to the order of
the sums).  On the card, cuDNN runs f32 convolutions in TF32 unless
``torch.backends.cudnn.allow_tf32`` is False; bf16 values are exact in TF32,
so only the calibration pass (f32 activations) depends on that flag.

Layouts follow the JAX package: NHWC activations, HWIO weights, the
``[22, 2]`` scale matrix with rows 0-19 for the backbone convs, row 20 for
the neck output (unused in engine mode) and row 21 for the concat.

``valid_hw`` runs the masked native-size forward over a batch padded to a
common bucket: cells beyond each image's extent are held at the zero-point
code (which dequantizes to exactly 0), the extents floor-halve at the pools
and in the lifted s2d stem, the border correction applies at the bucket's
bottom/right edge only to images that reach it, and the quadrant reorg
splits each image at its own half extents.  With the plain stem the codes
entering the neck equal each image's native-size run bit for bit.

A model sharded over the mesh's model axis runs the engine and its
calibration on each rank's output channels of the wide convs, gathering
the int8 codes (:func:`yolov2_int8_forward`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from odc_tpu_torch.models.backbones.darknet19 import _STAGES
from odc_tpu_torch.models.layers import (
    IMAGENET_MEAN, IMAGENET_STD, extent_mask,
)
from odc_tpu_torch.models.yolov2 import quadrant_stack, quadrant_stack_dynamic
from odc_tpu_torch.ops.quantize import (
    conv_i8, hwio, quantize_weights_per_channel,
)
from odc_tpu_torch.parallel.mesh import (
    ModelShard, gather_channels, shard_of,
)

# Input activation scale is static: ImageNet-normalized pixels span
# [-(0.485/0.229), (1-0.406)/0.225] within [-2.2, 2.7].
_INPUT_AMAX = 2.7


def scales_tensor(scales, device) -> torch.Tensor:
    """A scale matrix given as a tensor or a numpy array (the JAX package's
    ``calibrate`` output) as an f32 tensor on ``device``."""
    if isinstance(scales, torch.Tensor):
        return scales.to(device=device, dtype=torch.float32)
    return torch.tensor(scales, dtype=torch.float32, device=device)


def _blocks(model) -> List[Tuple[Dict, Dict, Dict, Optional[ModelShard]]]:
    """(conv_params, bn_params, bn_stats, shard) for every ConvBnLeaky of
    the port's YOLOv2 in forward order, 20 backbone convs then the neck
    conv, in the JAX package's names and layout (HWIO ``kernel``, f32).
    ``shard``: the conv's output channels over the mesh's model axis
    (``parallel/mesh.py::shard_model``), or None.  A sharded block's
    ``kernel`` holds the rank's output channels only; its conv bias and BN
    vectors are replicated, whole (:func:`_on_slice` cuts them).  A model
    without a Darknet-19 backbone and a neck (a YOLOv1, YOLOv3 or YOLOv4)
    raises ``ValueError``: the engine's graph is the YOLOv2's."""
    from odc_tpu_torch.models.backbones.darknet19 import Darknet19Backbone

    if not (isinstance(getattr(model, "backbone", None), Darknet19Backbone)
            and hasattr(model, "neck")):
        raise ValueError("the int8 engine and its calibration run a YOLOv2 "
                         f"only (got {type(model).__name__})")
    blocks = [blk for stage in model.backbone.stages for blk in stage]
    out = []
    for blk in blocks + [model.neck]:
        out.append((
            {"kernel": hwio(blk.conv.weight.float()), "bias": blk.conv.bias},
            {"scale": blk.bn.weight, "bias": blk.bn.bias},
            {"mean": blk.bn.running_mean, "var": blk.bn.running_var},
            shard_of(blk.conv),
        ))
    return out


def _on_slice(shard, conv_p, bn_p, bn_s):
    """A block's parameters on the rank's output channels: the sharded
    kernel is the slice already, the replicated conv bias and BN vectors
    are cut to it.  Unsharded (``shard`` None): as they are."""
    if shard is None:
        return conv_p, bn_p, bn_s

    def cut(d):
        return {k: shard.local(v) for k, v in d.items()}

    return ({"kernel": conv_p["kernel"], "bias": shard.local(conv_p["bias"])},
            cut(bn_p), cut(bn_s))


def _affine(conv_p, bn_p, bn_s, sw, sx, eps=1e-5):
    """Per-channel (A, B) of the fused dequant+bias+BN epilogue."""
    g = bn_p["scale"] / torch.sqrt(bn_s["var"] + eps)
    a = (sx * sw) * g
    b = (conv_p["bias"] - bn_s["mean"]) * g + bn_p["bias"]
    return a, b


def _float_epilogue(y, conv_p, bn_p, bn_s, eps=1e-5):
    """Conv bias, inference BN and leaky of a float conv output, in f32."""
    g = bn_p["scale"] / torch.sqrt(bn_s["var"] + eps)
    y = (y + conv_p["bias"] - bn_s["mean"]) * g + bn_p["bias"]
    return F.leaky_relu(y, 0.1)


def _act_qparams(stat_row):
    """[pos_max, neg_max] -> (scale, zero_point) mapping
    [-neg_max, pos_max] onto the full int8 range."""
    pos, neg = stat_row[0], stat_row[1]
    s = (pos + neg).clamp_min(1e-6) / 255.0
    z = torch.round(-128.0 + neg / s)
    return s, z


def _quant_act(y, s, z):
    return torch.clamp(torch.round(y / s + z), -128, 127).to(torch.int8)


def _percentile(t, q: float):
    """``jnp.percentile(t, q)`` (linear interpolation, f32 positions) over
    all elements.  Sorts instead of ``torch.quantile``, which refuses more
    than 2**24 elements."""
    s = t.flatten().sort().values
    f32 = dict(dtype=torch.float32, device=s.device)
    last = torch.tensor(float(s.numel()), **f32) - 1.0
    pos = torch.tensor(q, **f32) / 100.0 * last
    low, high = torch.floor(pos), torch.ceil(pos)
    w_high = pos - low
    w_low = 1.0 - w_high
    lo = s[low.clamp(0, last).long()]
    hi = s[high.clamp(0, last).long()]
    return lo * w_low + hi * w_high


def _range_stat(y, stat):
    """[pos_max, neg_max] of an activation (calibration mode)."""
    return torch.stack([stat(torch.clamp_min(y, 0.0)),
                        stat(torch.clamp_min(-y, 0.0))])


def _edge_sums(wq):
    """Kernel mass of each edge row/col and corner of an HWIO int8 kernel,
    f32 per output channel: top, bottom, left, right, tl, tr, bl, br."""
    wf = wq.float()
    return (wf[0].sum((0, 1)), wf[-1].sum((0, 1)), wf[:, 0].sum((0, 1)),
            wf[:, -1].sum((0, 1)), wf[0, 0].sum(0), wf[0, -1].sum(0),
            wf[-1, 0].sum(0), wf[-1, -1].sum(0))


def _border_masks(hw, device):
    h, w = hw
    row = torch.arange(h, device=device).reshape(1, h, 1, 1)
    col = torch.arange(w, device=device).reshape(1, 1, w, 1)
    return ((row == 0).float(), (row == h - 1).float(),
            (col == 0).float(), (col == w - 1).float())


def _zp_border_correction(wq, z, hw, eh=None, ew=None):
    """Zero-point correction for a 3x3 SAME conv over asymmetric codes.

    With input codes q (x = s*(q - z)), the SAME-0 conv computes
    acc = sum_in(w*q); the true conv is s*acc - s*z*wsum + s*z*W_out(pos),
    where W_out(pos) is the kernel mass falling outside the image: zero in
    the interior, rank-1 row/col patterns at the borders.  Returns the
    (z*W_out) term, broadcastable to [1, H, W, C].

    With per-image extents ``eh``/``ew`` ([B] integer tensors; the masked
    native-size path, the JAX package's ``_zp_border_correction_native``),
    cells beyond each extent hold the zero-point code (:func:`_mask_codes`),
    which dequantizes to exactly 0, so an image's interior bottom/right
    boundary gets its padding from the masked region with no correction:
    the bottom row / right column terms apply only to images whose extent
    reaches the bucket's edge (``eh == H`` / ``ew == W``), and the term is
    [B, H, W, C]-broadcastable."""
    wtop, wbot, wleft, wright, wtl, wtr, wbl, wbr = _edge_sums(wq)
    top, bot, left, right = _border_masks(hw, wq.device)
    if eh is not None:
        h, w = hw
        bot = bot * (eh == h).float()[:, None, None, None]
        right = right * (ew == w).float()[:, None, None, None]
    w_out = (
        top * wtop + bot * wbot + left * wleft + right * wright
        - top * left * wtl - top * right * wtr
        - bot * left * wbl - bot * right * wbr
    )
    return z * w_out


def _mask_codes(h, eh, ew, z):
    """Set cells beyond each image's (eh, ew) extent to the zero-point code
    ``z`` (0 where ``z`` is None), which dequantizes to exactly 0: the
    int8 counterpart of the float masked forward's zeroing.  The border
    windows of the next k > 1 conv then read what a native-size run's
    implicit SAME padding supplies."""
    zc = (torch.round(z).to(h.dtype) if z is not None
          else torch.zeros((), dtype=h.dtype, device=h.device))
    return torch.where(extent_mask(h.shape, eh, ew), h, zc)


def _zp_border_correction_lifted(wq, z, hw):
    """Zero-point correction for a LIFTED 3x3 conv (:func:`_s2d_stem_kernel`:
    4x4/stride-2, one row/col of padding a side, channel layout p*C+c with
    phase p = pi*2+pj).  Fine row 0 is (output row 0, pi=0) and fine row
    2H-1 is (row H-1, pi=1), so each edge term applies to the phase groups
    it reaches, and likewise for columns.  ``hw`` is the lifted OUTPUT
    spatial shape."""
    wtop, wbot, wleft, wright, wtl, wtr, wbl, wbr = _edge_sums(wq)
    zz = torch.zeros_like(wtop)
    # phase order p = pi*2 + pj: (0,0), (0,1), (1,0), (1,1)
    top_v = torch.cat([wtop, wtop, zz, zz])
    bot_v = torch.cat([zz, zz, wbot, wbot])
    left_v = torch.cat([wleft, zz, wleft, zz])
    right_v = torch.cat([zz, wright, zz, wright])
    tl_v = torch.cat([wtl, zz, zz, zz])
    tr_v = torch.cat([zz, wtr, zz, zz])
    bl_v = torch.cat([zz, zz, wbl, zz])
    br_v = torch.cat([zz, zz, zz, wbr])
    top, bot, left, right = _border_masks(hw, wq.device)
    w_out = (
        top * top_v + bot * bot_v + left * left_v + right * right_v
        - top * left * tl_v - top * right * tr_v
        - bot * left * bl_v - bot * right * br_v
    )
    return z * w_out


def _s2d_stem_kernel(k):
    """Lift a 3x3/s1 HWIO kernel [3, 3, Cin, Cout] to a 4x4/s2 kernel
    [4, 4, Cin, 4*Cout] computing all four output phases at once: with one
    row/col of padding and stride 2, output cell (i, j) reads input rows
    2i-1..2i+2, the union of the 3x3 windows of the four original outputs
    (2i+pi, 2j+pj).  Phase p = (pi, pj)'s tap (dy, dx) lands at kernel
    position (pi+dy+1, pj+dx+1) and writes output channel p*Cout+co."""
    _, _, cin, cout = k.shape
    w = k.new_zeros((4, 4, cin, 4 * cout))
    for pi in range(2):
        for pj in range(2):
            p = pi * 2 + pj
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    w[pi + dy + 1, pj + dx + 1, :,
                      p * cout : (p + 1) * cout] = k[dy + 1, dx + 1]
    return w


def _phase_max(y):
    """2x2 maxpool of the original grid == channelwise max over the 4
    phase groups of the s2d representation (monotone requant commutes)."""
    b, h, w, c4 = y.shape
    return y.reshape(b, h, w, 4, c4 // 4).amax(dim=3)


def _conv_f32(x, kernel, stride=1, padding="same"):
    """NHWC ``x`` (*) HWIO ``kernel`` in f32 (zero padding)."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2),
                 kernel.float().permute(3, 2, 0, 1), stride=stride,
                 padding=padding)
    return y.permute(0, 2, 3, 1)


def _conv_bf16(x, kernel, stride=1, padding="same"):
    """bf16 operands, f32 sums: the f32 conv of the bf16-rounded tensors
    (JAX's ``preferred_element_type=f32`` on bf16 inputs)."""
    return _conv_f32(x.to(torch.bfloat16), kernel.to(torch.bfloat16), stride,
                     padding)


def _pool(x):
    """2x2/2 max pool, floor, of an NHWC map of any dtype.  Float maps go
    through ``F.max_pool2d``, whose gradient goes to the first maximum of a
    window, as XLA's ``max_pool`` gradient does (``amax`` would split it
    between ties, and the QAT twin's fake-quantized maps tie often); int8
    codes through a reshape and ``amax``."""
    if x.is_floating_point():
        return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    b, hh, ww, c = x.shape
    h, w = hh // 2, ww // 2
    return x[:, : 2 * h, : 2 * w].reshape(b, h, 2, w, 2, c).amax(dim=(2, 4))


# Stage of each of the 20 backbone convs, and the last conv of each stage.
_STAGE_OF: List[int] = [si for si, stage in enumerate(_STAGES) for _ in stage]
_LAST_OF_STAGE = {si: max(i for i, s in enumerate(_STAGE_OF) if s == si)
                  for si in range(len(_STAGES))}


@torch.no_grad()
def yolov2_int8_forward(
    model,
    images,
    scales=None,
    num_anchor_box: int = 5,
    num_cls: int = 20,
    calib_percentile: Optional[float] = None,
    stop_after: Optional[int] = None,
    bf16_front: int = 0,
    stem: str = "plain",
    valid_hw=None,
):
    """Run YOLOv2 inference over the port's ``model`` (a quadrant-neck
    :class:`~odc_tpu_torch.models.yolov2.YOLOv2`; its f32 parameters and BN
    running statistics are read, its compute dtype is not).

    ``images``: [N, H, W, 3] uint8 NHWC on the model's device.

    With ``scales`` (a [22, 2] matrix from :func:`calibrate`, a tensor or a
    numpy array): full-int8 engine, returns the raw head [N, Hg, Wg, A, 5+C]
    f32.  With ``scales=None``: f32 calibration mode, returns (head, ranges
    [22, 2]) with this batch's observed values.

    ``stem``: ``"plain"`` quantizes from the first conv; ``"s2d"`` (the
    ``make_infer_fn`` default) folds conv0 + pool into one 4x4/stride-2 bf16
    conv; ``"s2d2"`` also lifts conv1 + pool, in int8 (an exact
    reformulation of ``"s2d"``).  ``bf16_front`` runs the first convs in
    bf16.  ``stop_after`` returns the codes after backbone conv ``i`` (0-19),
    the neck input (21) or the neck output (22).  ``calib_percentile``
    clips each calibration range at that percentile of |activation|.

    ``valid_hw`` ([N, 2] native sizes, a tensor or array; engine mode with
    ``stem`` plain or s2d and ``bf16_front=0`` only): the masked native-size
    forward of a batch padded top-left to a common bucket.  Cells
    ``[:h // 32, :w // 32]`` of each image's head equal its native-size
    engine run; the cells beyond are junk the caller masks.

    On the mesh's model axis (a model after ``parallel.shard_model``;
    every rank of the model group calls with the same images) a sharded
    block runs on the rank's output channels: in engine mode the int8 GEMM
    at N = the slice, the epilogue on the slice's conv bias and BN, leaky
    and the requantization at ``scales[i]``, then an all-gather of the
    int8 CODES along channels (the neck's f32 output is gathered as f32).
    The GEMM is exact and all after it is elementwise per channel, so the
    codes and the head are the unsharded engine's bit for bit.
    Calibration gathers the f32 conv output before the epilogue and
    :func:`_range_stat` (a range is over the whole tensor).  ``valid_hw``,
    ``stem="s2d2"`` and ``bf16_front`` do not run sharded."""
    blocks = _blocks(model)
    if any(blk[3] is not None for blk in blocks) and (
            valid_hw is not None or stem == "s2d2" or bf16_front > 0):
        raise ValueError(
            "a model sharded over the mesh's model axis runs the engine "
            "with stem 'plain' or 's2d', bf16_front=0 and no valid_hw")
    calibrating = scales is None
    stat = (
        (lambda t: t.abs().amax())
        if calib_percentile is None
        else (lambda t: _percentile(t.abs(), calib_percentile))
    )
    device = images.device
    if not calibrating:
        scales = scales_tensor(scales, device)
        if tuple(scales.shape) != (len(blocks) + 1, 2):
            raise ValueError(
                f"scales must have shape ({len(blocks) + 1}, 2) "
                f"((pos, neg) range per ConvBnLeaky + the concat), got "
                f"{tuple(scales.shape)}"
            )
    if stem not in ("plain", "s2d", "s2d2"):
        raise ValueError(
            f"stem must be 'plain', 's2d' or 's2d2', got {stem!r}"
        )
    amaxes = []

    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device)
    h0 = (images.float() / 255.0 - mean) / std
    s_in = torch.tensor(_INPUT_AMAX / 127.0, dtype=torch.float32,
                        device=device)
    eh = ew = None
    if valid_hw is not None:
        if calibrating:
            raise ValueError(
                "valid_hw is engine-mode only (calibrate on un-padded "
                "deployment-size batches)"
            )
        if bf16_front > 0 or stem == "s2d2":
            raise ValueError(
                "valid_hw supports stem='plain'/'s2d' with bf16_front=0 "
                "(the shipped configurations)"
            )
        valid_hw = torch.as_tensor(valid_hw, device=device).long()
        eh, ew = valid_hw[:, 0], valid_hw[:, 1]
        # The padded uint8 image is zero-filled; mask the NORMALIZED pixels
        # to 0 so the first conv's border windows read a native run's SAME
        # padding (the input layer is symmetric: code 0 is its zero point).
        h0 = _mask_codes(h0, eh, ew, None)

    if calibrating or bf16_front > 0 or stem != "plain":
        # The leading convs stay float (bf16_front, the s2d stems) or f32
        # (calibration).
        h = h0
    else:
        h = torch.clamp(torch.round(h0 / s_in), -127, 127).to(torch.int8)

    s_prev = s_in
    z_prev = None  # input layer is symmetric (zero point 0, SAME padding)
    c5 = None
    c5_idx = _LAST_OF_STAGE[4]

    pooled_to = 0  # stages whose entry pool a lifted conv already fused
    for i, (conv_p, bn_p, bn_s, shard) in enumerate(blocks[:20]):
        si = _STAGE_OF[i]
        first_of_stage = i == 0 or _STAGE_OF[i - 1] != si
        if first_of_stage and 1 <= si <= 5 and si > pooled_to:
            h = _pool(h)
            if eh is not None:
                # Floor-halving extents: a valid pool output (i < e//2)
                # reads only rows 2i, 2i+1 < e, so masked cells never leak.
                eh, ew = eh // 2, ew // 2

        if not calibrating and i == 0 and stem in ("s2d", "s2d2"):
            # s2d stem: stage-1 conv + 2x2 pool as ONE 4x4/stride-2 bf16
            # conv (see _s2d_stem_kernel) + a channelwise phase-max.
            wl = _s2d_stem_kernel(conv_p["kernel"].float())
            y = _conv_bf16(h, wl, stride=2, padding=1)
            g = bn_p["scale"] / torch.sqrt(bn_s["var"] + 1e-5)
            aff_a = g.repeat(4)
            aff_b = ((conv_p["bias"] - bn_s["mean"]) * g
                     + bn_p["bias"]).repeat(4)
            y = F.leaky_relu(y * aff_a + aff_b, 0.1)
            s_out, z_out = _act_qparams(scales[0])
            h = _phase_max(_quant_act(y, s_out, z_out))
            s_prev, z_prev = s_out, z_out
            pooled_to = 1
            if eh is not None:
                # The lifted conv + phase-max IS conv0 + pool: extents halve.
                eh, ew = eh // 2, ew // 2
            if stop_after == 0:
                return h
            continue

        if not calibrating and i == 1 and stem == "s2d2":
            # Lifted conv1: the same lift applied to the stage-2 3x3 conv +
            # its pool, in int8: the interior zero-point term folds into the
            # tiled bias, the border term is the phase-aware correction.
            wq, sw = quantize_weights_per_channel(conv_p["kernel"])
            a, b = _affine(conv_p, bn_p, bn_s, sw, s_prev)
            wsum = wq.float().sum(dim=(0, 1, 2))
            a4 = a.repeat(4)
            b4 = (b - z_prev * wsum * a).repeat(4)
            acc = conv_i8(h, _s2d_stem_kernel(wq), stride=2).float()
            out_hw = (h.shape[1] // 2, h.shape[2] // 2)
            acc = acc + _zp_border_correction_lifted(wq, z_prev, out_hw)
            y = F.leaky_relu(acc * a4 + b4, 0.1)
            s_out, z_out = _act_qparams(scales[1])
            h = _phase_max(_quant_act(y, s_out, z_out))
            s_prev, z_prev = s_out, z_out
            pooled_to = 2
            if stop_after == 1:
                return h
            continue

        if calibrating:
            y = gather_channels(shard, _conv_f32(h, conv_p["kernel"]))
            h = _float_epilogue(y, conv_p, bn_p, bn_s)
            amaxes.append(_range_stat(h, stat))
        elif i < bf16_front:
            # bf16 conv + f32 epilogue; quantize the OUTPUT so the next
            # int8 layer sees the standard (scales[i]) activation codes.
            y = _float_epilogue(_conv_bf16(h, conv_p["kernel"]), conv_p, bn_p,
                                bn_s)
            s_out, z_out = _act_qparams(scales[i])
            if i + 1 < bf16_front:
                h = y.to(torch.bfloat16)  # stay float until the switch
            else:
                h = _quant_act(y, s_out, z_out)
            s_prev, z_prev = s_out, z_out
        else:
            wq, sw = quantize_weights_per_channel(conv_p["kernel"])
            a, b = _affine(*_on_slice(shard, conv_p, bn_p, bn_s), sw, s_prev)
            if eh is not None and wq.shape[0] > 1:
                # Masked path: out-of-extent cells at the zero-point code,
                # so this conv's boundary windows read native SAME padding
                # (1x1 convs read no neighbourhood).
                h = _mask_codes(h, eh, ew, z_prev)
            acc = acc_f = conv_i8(h, wq).float()
            if z_prev is not None:
                # zero-point correction: interior folds into the bias,
                # the border ring adds rank-1 broadcasts.
                wsum = wq.float().sum(dim=(0, 1, 2))
                b = b - z_prev * wsum * a
                if wq.shape[0] > 1:
                    acc_f = acc + _zp_border_correction(
                        wq, z_prev, h.shape[1:3], eh, ew
                    )
            y = F.leaky_relu(acc_f * a + b, 0.1)
            s_out, z_out = _act_qparams(scales[i])
            h = gather_channels(shard, _quant_act(y, s_out, z_out))
            s_prev, z_prev = s_out, z_out
        if i == c5_idx:
            c5 = h
            s_c5, z_c5 = s_prev, z_prev
            e_c5 = (eh, ew)  # c5 grid extents = valid_hw // 16
        if stop_after == i:
            return h

    # Quadrant passthrough + concat: re-quantize both sides to a common
    # scale (int8 path only; f32 concatenates directly).
    quad = (quadrant_stack(c5) if eh is None
            else quadrant_stack_dynamic(c5, *e_c5))
    if calibrating:
        cat = torch.cat([quad, h], -1)
        amaxes.append(_range_stat(cat, stat))
        neck_in = cat
    else:
        s_cat, z_cat = _act_qparams(scales[21])

        def requant(q, s_from, z_from):
            r = s_from / s_cat
            return torch.clamp(
                torch.round(q.float() * r + (z_cat - z_from * r)), -128, 127
            ).to(torch.int8)

        neck_in = torch.cat(
            [requant(quad, s_c5, z_c5), requant(h, s_prev, z_prev)], -1
        )
        if eh is not None:
            # Valid neck grid = valid_hw // 32 (the c7 extents after five
            # pools); mask to the concat's zero point before the 3x3 conv.
            neck_in = _mask_codes(neck_in, eh, ew, z_cat)

    if stop_after == 21:  # after the quadrant concat / requant
        return neck_in

    conv_p, bn_p, bn_s, shard = blocks[20]
    if calibrating:
        y = gather_channels(shard, _conv_f32(neck_in, conv_p["kernel"]))
        neck = _float_epilogue(y, conv_p, bn_p, bn_s)
        amaxes.append(_range_stat(neck, stat))
    else:
        wq, sw = quantize_weights_per_channel(conv_p["kernel"])
        a, b = _affine(*_on_slice(shard, conv_p, bn_p, bn_s), sw, s_cat)
        wsum = wq.float().sum(dim=(0, 1, 2))
        b = b - z_cat * wsum * a
        acc = conv_i8(neck_in, wq).float()
        acc = acc + _zp_border_correction(wq, z_cat, neck_in.shape[1:3], eh, ew)
        neck = gather_channels(shard, F.leaky_relu(acc * a + b, 0.1))
    if stop_after == 22:  # after the neck conv
        return neck

    # The 1x1 head stays float on the f32 neck output, bf16 operands as in
    # JAX (whose bf16 conv rounds its output to bf16 before the bias; the
    # calibration pass runs it in f32).  scales[20] is unused here.
    head_w = hwio(model.head.weight.float())
    if calibrating:
        y = _conv_f32(neck, head_w) + model.head.bias
    else:
        y = _conv_bf16(neck, head_w).to(torch.bfloat16).float()
        y = y + model.head.bias

    n, hg, wg, _ = y.shape
    y = y.reshape(n, hg, wg, num_anchor_box, 5 + num_cls)
    if calibrating:
        # range order: 20 backbone convs, [20]=neck out, [21]=concat.
        a = amaxes[:20] + [amaxes[21], amaxes[20]]
        return y, torch.stack(a)
    return y


def calibrate(model, sample_images, percentile: Optional[float] = None):
    """One-off PTQ calibration: per-requant-point activation range over the
    sample batch (f32 engine pass).  ``percentile`` optionally clips
    outliers (e.g. 99.99).  Returns a [22, 2] f32 (pos_max, neg_max) tensor
    on the model's device to pass as ``scales``.

    The pass runs f32 convolutions: on the card, set
    ``torch.backends.cudnn.allow_tf32 = False`` first, or cuDNN computes
    them in TF32 and the ranges move by about 1e-3 relative.

    On the mesh's model axis every rank of the model group calls it on the
    same images and gets the same ranges: each sharded layer's f32 output
    is gathered before its range is taken."""
    _, amaxes = yolov2_int8_forward(
        model, sample_images, scales=None, calib_percentile=percentile
    )
    return amaxes.clamp_min(1e-6)
