"""Bulk detection: a closed loop over ``make_infer_fn(compact=True)``.

Traffic (the cell's ``mix`` object): ``batch`` uint8 images a call,
cycled from ``distinct_batches`` seeded batches in pinned host memory; each
call copies its batch to the card, runs, and copies the compact outputs
back (one call in flight).  ``infer_img_per_s`` is every image of every
call over the time from the window's start to the last completion.

The confidence threshold is set at set-up by the reference, in the largest
gap of the first batch's sorted candidate confidences that keeps
``keep_lo``-``keep_hi`` boxes an image.  After the window the reference
judges the outputs of ``judged_calls`` calls drawn from the seed.
"""

from __future__ import annotations

import random
import time
import types

import torch

from benchmark import harness
from benchmark.reference import calibrate, detect, nets


def make_images(n: int, hw, seed: int, device) -> torch.Tensor:
    """``n`` uint8 [H, W, 3] images from ``seed``, drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, (n, *hw, 3), generator=gen, device=device,
                         dtype=torch.uint8)


def reference_candidates(cfg, sd, images, block: int, conv=nets.conv_f32):
    """The reference's decoded candidates of ``images`` (on the weights'
    device), ``block`` images at a time, TF32 off."""
    parts = []
    dev = next(iter(sd.values())).device
    with torch.no_grad(), harness.ieee_f32():
        net = nets.net(cfg, sd, conv=conv)
        for i in range(0, images.shape[0], block):
            x = images[i:i + block].to(dev)
            parts.append(detect.decode(cfg, net.forward(x)))
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


def program_model(cfg, sd, device):
    """The port's model of ``cfg`` in its compute dtype, loaded with
    ``sd``."""
    from odc_tpu_torch.models import get_model

    model = get_model(cfg["model"], dtype=getattr(torch, cfg["compute_dtype"]),
                      device=device, image_size=tuple(cfg["image_size"]))
    model.load_state_dict(sd)
    return model


def setup(ctx):
    from odc_tpu_torch.ops.detect import make_infer_fn

    cfg, t, dev = ctx.cfg, ctx.cell["mix"], ctx.device
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


def _call(st, i, rec):
    x_host = st.host[i % st.host.shape[0]]
    with rec.span("h2d"):
        x = x_host.to(st.ctx.device, non_blocking=True)
    with rec.span("enqueue"):
        if st.trace is not None:
            st.trace.start()
        out = st.infer(x)
        if st.trace is not None:
            st.trace.end()
    with rec.span("d2h"):
        host = [o.cpu() for o in out]
    return host


def window(st, seconds: float, rec):
    calls = 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    last = t0
    while last < deadline:
        out = _call(st, calls, rec)
        last = time.perf_counter()
        st.outputs.append(out)
        calls += 1
    n = st.host.shape[1]
    st.window_s = last - t0
    rate = calls * n / st.window_s
    return {"metrics": {"infer_img_per_s": (rate, "img/s")},
            "attempted": calls * n, "failed": 0,
            "log": [f"{calls} calls of {n} in {st.window_s:.3f} s: "
                    f"{rate:.3f} img/s at conf {st.conf_thre:.6f}"]}


class _Instruments:
    """CUDA events at the backbone's entry and exit, the head's output and
    the call's end (the on-card smoke script's module-hook pattern), and
    the NMS's valid-candidate counts (read after the window)."""

    def __init__(self, model, device):
        import odc_tpu_torch.core.nms as nms_mod

        self.valid = []
        self.calls = []
        self.active = False

        def mark(name):
            def hook(*_):
                if self.active and device == "cuda":
                    ev = torch.cuda.Event(enable_timing=True)
                    ev.record()
                    self.calls[-1][name] = ev
            return hook

        model.backbone.register_forward_pre_hook(mark("backbone_in"))
        model.backbone.register_forward_hook(mark("backbone_out"))
        model.register_forward_hook(mark("head_out"))
        self._mark_end = mark("end")
        original = nms_mod.suppress

        def counting(boxes, valid, iou_thre):
            if self.active:
                self.valid.append(valid.sum(1))
            return original(boxes, valid, iou_thre)

        nms_mod.suppress = counting
        from odc_tpu_torch.ops.cuda.nms_kernel import suppress
        from odc_tpu_torch.ops.cuda.superstem_kernel import superstem

        self.kernels = {"superstem": superstem, "nms": suppress}
        self.start_launches = {}

    def start(self):
        if not self.active:
            self.active = True
            self.start_launches = {k: f.launches for k, f in self.kernels.items()}
        self.calls.append({})

    def end(self):
        self._mark_end()


def trace_values(st, tr):
    ins = st.trace
    if st.ctx.device == "cuda":
        torch.cuda.synchronize()
    backbone, tail = [], []
    for c in ins.calls:
        if "backbone_in" in c and "backbone_out" in c:
            backbone.append(c["backbone_in"].elapsed_time(c["backbone_out"]))
        if "head_out" in c and "end" in c:
            tail.append(c["head_out"].elapsed_time(c["end"]))
    tr.device_ms["backbone"] = backbone
    tr.device_ms["decode_nms"] = tail
    n = st.host.shape[1]
    tr.counters["images"] = len(st.outputs) * n
    tr.counters["batch"] = n
    for k, f in ins.kernels.items():
        tr.counters[k + "_launches"] = f.launches - ins.start_launches.get(k, 0)
    if ins.valid:
        tr.values["nms_valid"] = torch.cat(ins.valid).cpu().tolist()
    tr.values["max_keep"] = st.ctx.cell["mix"]["max_keep"]
    tr.values["image_hw"] = tuple(st.ctx.cfg["image_size"])


def check(st):
    """The reference's judgement of ``judged_calls`` calls drawn from the
    seed (the program's state freed first)."""
    ctx, t = st.ctx, st.ctx.cell["mix"]
    calls = len(st.outputs)
    rng = random.Random(harness.sub_seed(ctx.seed, 4))
    picked = sorted(rng.sample(range(calls), min(t["judged_calls"], calls)))
    outputs = [st.outputs[i] for i in picked]
    st.model = st.infer = st.trace = None
    st.outputs = []
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    return judge_calls(ctx.cfg, st.sd, [st.host[i % st.host.shape[0]] for i in picked],
                       outputs, st.conf_thre, t)


def judge_calls(cfg, sd, images, outputs, conf_thre, t):
    """Pool :func:`detect.judge` over calls: the worst gaps, the pooled
    shares."""
    worst = {"conf_gap": 0.0, "size_gap": 0.0, "label_gap": 0.0}
    means = ("conf_mad", "size_mad", "label_miss", "extra", "overlap")
    sums = dict.fromkeys(means + ("missed", "reference", "served"), 0.0)
    for x, out in zip(images, outputs):
        ref = reference_candidates(cfg, sd, x, t["reference_block"])
        boxes, conf, label, _, keep = out
        r = detect.judge(cfg, ref, dict(boxes=boxes, conf=conf, label=label,
                                        keep=keep),
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
