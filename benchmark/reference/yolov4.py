"""Plain float32 YOLOv4 (CSPDarknet53-Mish, SPP, PANet), from a state dict.

The benchmark's own reference for ``"model": "YOLOv4"`` configurations,
written from the paper (Bochkovskiy, Wang & Liao, arXiv:2004.10934) and
``cfg/yolov4.cfg`` of AlexeyAB/darknet with the configuration's stage
widths and repeats: NCHW ``F.conv2d`` through ``nets.Net``'s ``conv``
callable (so ``nets.conv_fp8`` serves as the float8 control), BatchNorm on
running statistics, Mish (``x * tanh(softplus(x))``) in the backbone,
LeakyReLU(0.1) in the neck, every conv padded ``k // 2`` on every side.  It
imports nothing of the program; parameter names follow the program's
checkpoint layout so one state dict feeds both.

Besides the forward: the parameter layout (:func:`param_specs`), the FLOP
count (:func:`conv_flops_per_image`), the Mish blocks' output maps
(:func:`mish_maps`), the decode with YOLOv4's grid sensitivity
(:func:`decode`: ``bx = (sigmoid(tx) * s - (s - 1) / 2 + cx) * stride``),
and :func:`judge`, ``detect.judge`` with the served box tied to a candidate
of its centre's cell OR one of the 8 cells around it: ``s`` up to 1.2 moves
a centre up to 0.1 cell out of the cell it was decoded in.

:func:`register` hooks the model into ``nets.NETS``, ``nets.param_specs``
and ``counts.conv_flops_per_image`` (which dispatch on ``cfg["model"]``),
each other model still going to the code that was there; the package's
``__init__`` calls it, so seeded weights, BN calibration and the
configuration's recorded counts work for YOLOv4 as for the others.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark import counts
from benchmark.reference import detect, nets

LEAKY = nets.LEAKY


def _pad(k: int) -> Tuple[int, int, int, int]:
    p = k // 2
    return (p, p, p, p)


def upsample2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class YOLOv4Ref(nets.Net):
    """The network of the module docstring, heads coarsest first."""

    def __init__(self, cfg: dict, sd, **kw):
        super().__init__(sd, **kw)
        self.stages = cfg["csp_stages"]
        self.anchors = 3

    def block(self, name: str, x: torch.Tensor, stride: int = 1,
              act: str = "leaky") -> torch.Tensor:
        w = self.sd[name + ".conv.weight"]
        y = self.conv(x, w, self.sd[name + ".conv.bias"], stride,
                      _pad(w.shape[-1]))
        y = self.bn(name + ".bn", y)
        return F.mish(y) if act == "mish" else F.leaky_relu(y, LEAKY)

    def cbm(self, name, x, stride=1):
        return self.block(name, x, stride, "mish")

    def five(self, name: str, h: torch.Tensor) -> torch.Tensor:
        for k in range(5):
            h = self.block(f"{name}.{k}", h)
        return h

    def head(self, s: str, h: torch.Tensor) -> torch.Tensor:
        y = self.plain_conv("out" + s, self.block("head" + s, h))
        return nets._head_nhwc(y, self.anchors)

    def backbone(self, images_u8: torch.Tensor):
        h = self.cbm("backbone.stem", images_u8.permute(0, 3, 1, 2).float() / 255.0)
        taps = []
        for i, (_, repeat) in enumerate(self.stages):
            p = f"backbone.stages.{i}"
            d = self.cbm(p + ".down", h, stride=2)
            a = self.cbm(p + ".part_a", d)
            b = self.cbm(p + ".part_b", d)
            for r in range(repeat):
                q = f"{p}.blocks.{r}"
                b = b + self.cbm(q + ".expand", self.cbm(q + ".reduce", b))
            b = self.cbm(p + ".transition", b)
            h = self.cbm(p + ".fuse", torch.cat([b, a], dim=1))
            taps.append(h)
        return taps[2], taps[3], taps[4]

    def spp(self, x: torch.Tensor) -> torch.Tensor:
        for k in range(3):
            x = self.block(f"spp.pre.{k}", x)
        pools = [F.max_pool2d(x, s, 1, padding=s // 2) for s in (13, 9, 5)]
        x = torch.cat(pools + [x], dim=1)
        for k in range(3):
            x = self.block(f"spp.post.{k}", x)
        return x

    def forward(self, images_u8: torch.Tensor):
        c3, c4, c5 = self.backbone(images_u8)
        p5 = self.spp(c5)
        p4 = self.five("five16", torch.cat(
            [self.block("lateral16", c4), upsample2(self.block("reduce16", p5))], 1))
        p3 = self.five("five8", torch.cat(
            [self.block("lateral8", c3), upsample2(self.block("reduce8", p4))], 1))
        y8 = self.head("8", p3)
        n4 = self.five("bottom16", torch.cat([self.block("down16", p3, 2), p4], 1))
        y16 = self.head("16", n4)
        n5 = self.five("bottom32", torch.cat([self.block("down32", n4, 2), p5], 1))
        y32 = self.head("32", n5)
        return y32, y16, y8


# ----------------------------------------------------------------------------
# Layout and counts.


def _layers(cfg: dict) -> List[Tuple[str, int, int, int, int, str]]:
    """``(name, cin, cout, k, output stride, kind)`` of every convolution in
    forward order; ``kind`` is ``mish``, ``leaky`` or ``linear`` (a head
    conv with a bias and no BN)."""
    out = []

    def add(name, cin, cout, k, s, kind):
        out.append((name, cin, cout, k, s, kind))

    add("backbone.stem", 3, 32, 3, 1, "mish")
    cin, s = 32, 1
    for i, (c, repeat) in enumerate(cfg["csp_stages"]):
        p, s = f"backbone.stages.{i}", s * 2
        branch = c if i == 0 else c // 2
        add(p + ".down", cin, c, 3, s, "mish")
        add(p + ".part_a", c, branch, 1, s, "mish")
        add(p + ".part_b", c, branch, 1, s, "mish")
        for r in range(repeat):
            add(f"{p}.blocks.{r}.reduce", branch, c // 2, 1, s, "mish")
            add(f"{p}.blocks.{r}.expand", c // 2, branch, 3, s, "mish")
        add(p + ".transition", branch, branch, 1, s, "mish")
        add(p + ".fuse", 2 * branch, c, 1, s, "mish")
        cin = c

    def five(name, cin, f, s):
        for k, (ks, co) in enumerate(((1, f), (3, 2 * f), (1, f), (3, 2 * f), (1, f))):
            add(f"{name}.{k}", cin, co, ks, s, "leaky")
            cin = co

    for k, (ci, co, ks) in enumerate(((1024, 512, 1), (512, 1024, 3), (1024, 512, 1))):
        add(f"spp.pre.{k}", ci, co, ks, 32, "leaky")
    for k, (ci, co, ks) in enumerate(((2048, 512, 1), (512, 1024, 3), (1024, 512, 1))):
        add(f"spp.post.{k}", ci, co, ks, 32, "leaky")
    a = 3 * (5 + cfg["num_cls"])
    add("reduce16", 512, 256, 1, 32, "leaky")
    add("lateral16", 512, 256, 1, 16, "leaky")
    five("five16", 512, 256, 16)
    add("reduce8", 256, 128, 1, 16, "leaky")
    add("lateral8", 256, 128, 1, 8, "leaky")
    five("five8", 256, 128, 8)
    add("head8", 128, 256, 3, 8, "leaky")
    add("out8", 256, a, 1, 8, "linear")
    add("down16", 128, 256, 3, 16, "leaky")
    five("bottom16", 512, 256, 16)
    add("head16", 256, 512, 3, 16, "leaky")
    add("out16", 512, a, 1, 16, "linear")
    add("down32", 256, 512, 3, 32, "leaky")
    five("bottom32", 1024, 512, 32)
    add("head32", 512, 1024, 3, 32, "leaky")
    add("out32", 1024, a, 1, 32, "linear")
    return out


def param_specs(cfg: dict) -> List[tuple]:
    """``nets.param_specs``'s ``(name, shape, kind)`` list for YOLOv4."""
    out: List[tuple] = []
    for name, cin, cout, k, _, kind in _layers(cfg):
        if kind == "linear":
            out += nets._conv(name, cin, cout)
        else:
            out += nets._cbl(name, cin, cout, k)
    return out


def conv_flops_per_image(cfg: dict) -> float:
    """Forward FLOPs of one image: 2 x multiply-adds of every convolution
    at its output resolution (BatchNorm, activations, pools, upsampling,
    decode and NMS are not counted)."""
    h, w = cfg["image_size"]
    return sum(2.0 * (h // s) * (w // s) * cin * cout * k * k
               for _, cin, cout, k, s, _ in _layers(cfg))


def mish_maps(cfg: dict) -> List[Tuple[int, int, int]]:
    """``(H, W, C)`` of each Mish block's output, in forward order."""
    h, w = cfg["image_size"]
    return [(h // s, w // s, cout) for _, _, cout, _, s, kind in _layers(cfg)
            if kind == "mish"]


def register() -> None:
    """Hook YOLOv4 into the reference's dispatch on ``cfg["model"]`` (see
    the module docstring); idempotent."""
    if nets.NETS.get("YOLOv4") is YOLOv4Ref:
        return
    nets.NETS["YOLOv4"] = YOLOv4Ref
    specs, flops = nets.param_specs, counts.conv_flops_per_image

    def dispatch(mine, theirs):
        def pick(cfg):
            return (mine if cfg["model"] == "YOLOv4" else theirs)(cfg)
        pick.__doc__ = theirs.__doc__
        return pick

    nets.param_specs = dispatch(param_specs, specs)
    counts.conv_flops_per_image = dispatch(conv_flops_per_image, flops)


# ----------------------------------------------------------------------------
# Decode and the judge.


def decode(cfg: dict, heads) -> detect.Candidates:
    """(y32, y16, y8) -> flat candidates, ``detect.decode``'s order, the
    centres with ``cfg["scale_x_y"]`` (coarsest first)."""
    h, w = cfg["image_size"]
    parts = []
    for y, (hg, wg, anchors), k in zip(heads, detect.scales(cfg), cfg["scale_x_y"]):
        y = y.float()
        n, _, _, a, _ = y.shape
        sh, sw = h / hg, w / wg
        cy, cx = detect._cells(hg, wg, y.device)
        anchors = anchors.to(y.device)
        bx = (torch.sigmoid(y[..., 0]) * k - (k - 1) / 2 + cx) * sw
        by = (torch.sigmoid(y[..., 1]) * k - (k - 1) / 2 + cy) * sh
        bw = anchors[:, 0] * torch.exp(y[..., 2])
        bh = anchors[:, 1] * torch.exp(y[..., 3])
        boxes = torch.stack([bx - bw / 2, by - bh / 2, bx + bw / 2, by + bh / 2], -1)
        conf = torch.sigmoid(y[..., 4])
        score = torch.sigmoid(y[..., 5:]) * conf[..., None]
        g = hg * wg * a
        parts.append((boxes.reshape(n, g, 4), conf.reshape(n, g), score.reshape(n, g, -1)))
    return detect.Candidates(*(torch.cat(t, 1) for t in zip(*parts)))


def tie(cfg: dict, ref: detect.Candidates, served: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The reference candidate each served detection came from ([N, K]
    indices into the flat candidate axis): of the candidates at its
    centre's cell and the 8 cells around it, at every scale, the nearest in
    box (1 - IoU), objectness and the served label's score.

    The score tells apart two candidates whose boxes both fit: in bf16 a
    width or height may be 40% off its f32 value, so the box alone can
    prefer another anchor of the same cell or a cell of another scale,
    whose class scores are unrelated."""
    dev = ref.conf.device
    n = ref.conf.shape[0]
    boxes = served["boxes"].to(dev).float()
    conf = served["conf"].to(dev).float()
    label = served["label"].to(dev).long()
    label_score = served["label_score"].to(dev).float()
    h, w = cfg["image_size"]
    cx = ((boxes[..., 0] + boxes[..., 2]) / 2).clamp(0, w - 1e-3)
    cy = ((boxes[..., 1] + boxes[..., 3]) / 2).clamp(0, h - 1e-3)
    ids = []
    for off, hg, wg, a in detect.candidate_cells(cfg, dev):
        row = (cy / (h / hg)).long()
        col = (cx / (w / wg)).long()
        for dr in (-1, 0, 1):
            for dc in (-1, 0, 1):
                r = (row + dr).clamp(0, hg - 1)
                c = (col + dc).clamp(0, wg - 1)
                base = off + (r * wg + c) * a
                ids += [base + j for j in range(a)]
    ids = torch.stack(ids, -1)  # [N, K, candidates near the centre]
    flat = ids.reshape(n, -1)
    cand = ref.boxes.gather(1, flat[..., None].expand(-1, -1, 4)).view(*ids.shape, 4)
    c_conf = ref.conf.gather(1, flat).view(ids.shape)
    classes = ref.score.shape[-1]
    c_score = ref.score.reshape(n, -1).gather(
        1, (ids * classes + label[..., None]).reshape(n, -1)).view(ids.shape)
    dist = ((1 - detect.iou(boxes[..., None, :], cand))
            + (conf[..., None] - c_conf).abs()
            + (label_score[..., None] - c_score).abs())
    return ids.gather(-1, dist.argmin(-1, keepdim=True)).squeeze(-1)


def judge(cfg: dict, ref: detect.Candidates, served: Dict[str, torch.Tensor],
          conf_thre: float, iou_thre: float, max_keep: int) -> Dict[str, float]:
    """``detect.judge`` (same numbers, same meaning) with each served
    detection tied to its candidate by :func:`tie`, which looks beyond the
    centre's cell and weighs the served label's score too (``served`` also
    holds ``label_score [N, K]``)."""
    dev = ref.conf.device
    boxes = served["boxes"].to(dev).float()
    keep = served["keep"].to(dev).bool()
    conf = served["conf"].to(dev).float()
    label = served["label"].to(dev).long()
    pick = tie(cfg, ref, served)  # [N, K]
    r_box = ref.boxes.gather(1, pick[..., None].expand(-1, -1, 4))
    r_conf = ref.conf.gather(1, pick)
    r_score = ref.score.gather(1, pick[..., None].expand(-1, -1, ref.score.shape[-1]))
    served_n = int(keep.sum())
    out = {"served": served_n}
    if served_n:
        wh_p = (boxes[..., 2:] - boxes[..., :2]).clamp(min=1e-6)
        wh_r = (r_box[..., 2:] - r_box[..., :2]).clamp(min=1e-6)
        size = (wh_p / wh_r).log().abs().amax(-1)
        lab = r_score.amax(-1) - r_score.gather(-1, label[..., None]).squeeze(-1)
        dconf = (conf - r_conf).abs()[keep]
        out["conf_gap"] = float(dconf.max())
        out["conf_mad"] = float(dconf.mean())
        out["size_gap"] = float(size[keep].max())
        out["size_mad"] = float(size[keep].mean())
        out["label_gap"] = float(lab[keep].max())
        out["label_miss"] = float((lab[keep] > 0).float().mean())
        out["extra"] = float((r_conf[keep] < conf_thre).float().mean())
        k = keep.shape[1]
        pair = detect.iou(boxes[:, :, None], boxes[:, None, :]) >= iou_thre + detect.OVERLAP_TOL
        pair &= keep[:, :, None] & keep[:, None, :]
        pair &= ~torch.eye(k, dtype=torch.bool, device=dev)
        out["overlap"] = float(pair.any(-1)[keep].float().mean())
    else:
        out.update(conf_gap=0.0, conf_mad=0.0, size_gap=0.0, size_mad=0.0,
                   label_gap=0.0, label_miss=0.0, extra=0.0, overlap=0.0)
    order, rkeep = detect.nms(ref, conf_thre, iou_thre, max_keep)
    r_boxes = ref.boxes.gather(1, order[..., None].expand(-1, -1, 4))
    cover = detect.iou(r_boxes[:, :, None], boxes[:, None, :]) >= 0.5
    cover = (cover & keep[:, None, :]).any(-1)
    ref_n = int(rkeep.sum())
    out["reference"] = ref_n
    out["missed"] = float((rkeep & ~cover).sum()) / max(ref_n, 1)
    return out
