"""Bulk detection with a YOLOv4 configuration: ``bulk.py``'s closed loop
over ``make_infer_fn(compact=True)``, its traffic and its instruments, with
the reference's side from ``reference/yolov4.py``.

Traffic (the cell's ``mix``): as ``bulk.py`` says.  What differs is the
reference: YOLOv4's forward, its decode with grid sensitivity, and its
judge, which ties a served box to a candidate of its centre's cell or a
neighbouring one (``yolov4.judge``).  The program is built and timed, and
its spans and instruments read, by ``bulk.py``'s own functions.
"""

from __future__ import annotations

import random
import types

import torch

from benchmark import harness
from benchmark.drivers.bulk import (  # noqa: F401  (the harness calls them)
    _call, _Instruments, make_images, program_model, trace_values, window,
)
from benchmark.reference import calibrate, detect, nets, yolov4


def reference_candidates(cfg, sd, images, block: int, conv=nets.conv_f32):
    """The reference's decoded candidates of ``images`` (on the weights'
    device), ``block`` images at a time, TF32 off."""
    parts = []
    dev = next(iter(sd.values())).device
    with torch.no_grad(), harness.ieee_f32():
        net = yolov4.YOLOv4Ref(cfg, sd, conv=conv)
        for i in range(0, images.shape[0], block):
            x = images[i:i + block].to(dev)
            parts.append(yolov4.decode(cfg, net.forward(x)))
    return detect.Candidates(*(torch.cat(t) for t in zip(*parts)))


def prepare(ctx):
    """Weights from the seed, the reference's BN calibration: the f32
    state dict both sides get."""
    cfg, dev = ctx.cfg, ctx.device
    sd = nets.make_weights(cfg, harness.sub_seed(ctx.seed, 0), dev)
    cal = make_images(ctx.cell["mix"].get("calibration_images", 8),
                      cfg["image_size"], harness.sub_seed(ctx.seed, 1), dev)
    with harness.ieee_f32():
        calibrate.calibrate_bn(cfg, sd, cal, harness.sub_seed(ctx.seed, 2))
    ctx.mark("weights and BN calibration")
    return sd


def setup(ctx):
    from odc_tpu_torch.models.registry import model_class
    from odc_tpu_torch.ops.detect import make_infer_fn

    cfg, t, dev = ctx.cfg, ctx.cell["mix"], ctx.device
    model_class(cfg["model"])  # a program without the model fails here
    sd = prepare(ctx)
    hw = cfg["image_size"]
    batches = make_images(t["distinct_batches"] * t["batch"], hw,
                          harness.sub_seed(ctx.seed, 3), dev)
    host = batches.cpu().view(t["distinct_batches"], t["batch"], *hw, 3)
    if dev == "cuda":
        host = host.pin_memory()
    del batches
    ref = reference_candidates(cfg, sd, host[0], t["reference_block"])
    n = t["batch"]
    conf_thre = calibrate.gap_threshold(ref.conf, t["keep_lo"] * n,
                                        t["keep_hi"] * n)
    del ref
    if dev == "cuda":
        torch.cuda.empty_cache()
    ctx.mark("batches and threshold")
    model = program_model(cfg, sd, dev)
    infer = make_infer_fn(model, conf_thre, t["iou_thre"], t["max_keep"],
                          compact=True)
    ctx.mark("program model")
    st = types.SimpleNamespace(ctx=ctx, sd=sd, host=host, model=model,
                               infer=infer, conf_thre=conf_thre, outputs=[],
                               trace=None)
    for i in range(t["warmup_calls"]):
        _call(st, i, harness.Recorder(False))
    st.outputs.clear()
    ctx.mark("warm-up")
    if ctx.trace:
        st.trace = _Instruments(model, dev)
    return st


def judged_batches(seed: int, distinct: int, calls: int, judged: int):
    """The batches the reference judges: ``judged`` of the ``distinct``
    ones, drawn from the seed alone, so that two programs of different pace
    judge the same images at one seed.  Batch ``b`` is judged on the
    window's first call of it, call ``b``; a window of fewer calls than
    batches draws from the batches it ran."""
    rng = random.Random(harness.sub_seed(seed, 4))
    ran = min(distinct, calls)
    return sorted(rng.sample(range(ran), min(judged, ran)))


def check(st):
    """The reference's judgement of ``judged_calls`` batches drawn from the
    seed (:func:`judged_batches`; the program's state freed first)."""
    ctx, t = st.ctx, st.ctx.cell["mix"]
    picked = judged_batches(ctx.seed, st.host.shape[0], len(st.outputs),
                            t["judged_calls"])
    outputs = [st.outputs[b] for b in picked]
    st.model = st.infer = st.trace = None
    st.outputs = []
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    return judge_calls(ctx.cfg, st.sd, [st.host[b] for b in picked],
                       outputs, st.conf_thre, t)


def judge_calls(cfg, sd, images, outputs, conf_thre, t):
    """Pool :func:`yolov4.judge` over calls: the worst gaps, the pooled
    shares."""
    worst = {"conf_gap": 0.0, "size_gap": 0.0, "label_gap": 0.0}
    means = ("conf_mad", "size_mad", "label_miss", "extra", "overlap")
    sums = dict.fromkeys(means + ("missed", "reference", "served"), 0.0)
    for x, out in zip(images, outputs):
        ref = reference_candidates(cfg, sd, x, t["reference_block"])
        boxes, conf, label, label_score, keep = out
        r = yolov4.judge(cfg, ref, dict(boxes=boxes, conf=conf, label=label,
                                        label_score=label_score, keep=keep),
                         conf_thre, t["iou_thre"], t["max_keep"])
        for k in worst:
            worst[k] = max(worst[k], r[k])
        sums["missed"] += r["missed"] * r["reference"]
        for k in means:
            sums[k] += r[k] * r["served"]
        for k in ("reference", "served"):
            sums[k] += r[k]
    out = dict(worst, missed=sums["missed"] / max(sums["reference"], 1),
               served=sums["served"], reference=sums["reference"])
    out.update({k: sums[k] / max(sums["served"], 1) for k in means})
    return out


def control_outputs(cfg, sd, images, conf_thre, t):
    """The control put in the program's place: the reference computed in
    float8 (``nets.conv_fp8``), decoded and suppressed, in the program's
    output format."""
    c = reference_candidates(cfg, sd, images, t["reference_block"],
                             conv=nets.conv_fp8)
    return [o.cpu() for o in detect.served_format(c, conf_thre, t["iou_thre"],
                                                  t["max_keep"])]


def control(st):
    """The control's numbers for the first ``judged_calls`` batches."""
    t = st.ctx.cell["mix"]
    st.model = st.infer = st.trace = None
    images = [st.host[i % st.host.shape[0]] for i in range(t["judged_calls"])]
    outs = [control_outputs(st.ctx.cfg, st.sd, x, st.conf_thre, t) for x in images]
    return judge_calls(st.ctx.cfg, st.sd, images, outs, st.conf_thre, t)
