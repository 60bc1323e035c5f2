"""A plain float32 YOLOv4 for the port's tests: CSPDarknet53-Mish, SPP,
PANet and the three heads from a state dict in the port's parameter names,
decode with grid sensitivity, and greedy NMS.

Written from ``cfg/yolov4.cfg`` of AlexeyAB/darknet (arXiv:2004.10934):
NCHW ``F.conv2d`` padded ``k // 2`` on every side, BatchNorm on running
statistics (eps 1e-5), Mish in the backbone, LeakyReLU(0.1) in the neck.
Imports neither JAX nor the JAX package nor the port; TF32 is turned off
while it runs."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

STAGES = ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4))
SCALE_X_Y = (1.05, 1.1, 1.2)  # stride 32, 16, 8


@contextlib.contextmanager
def ieee_f32():
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


class PlainYOLOv4:
    def __init__(self, sd):
        self.sd = {k: v.float() for k, v in sd.items()}

    def block(self, name, x, stride=1, act="leaky"):
        w = self.sd[name + ".conv.weight"]
        y = F.conv2d(x, w, self.sd[name + ".conv.bias"], stride=stride,
                     padding=w.shape[-1] // 2)
        g = lambda k: self.sd[f"{name}.bn.{k}"].view(1, -1, 1, 1)  # noqa: E731
        y = (y - g("running_mean")) * torch.rsqrt(g("running_var") + 1e-5)
        y = y * g("weight") + g("bias")
        return F.mish(y) if act == "mish" else F.leaky_relu(y, 0.1)

    def cbm(self, name, x, stride=1):
        return self.block(name, x, stride, "mish")

    def backbone(self, x):
        h = self.cbm("backbone.stem", x)
        taps = []
        for i, (_, n) in enumerate(STAGES):
            p = f"backbone.stages.{i}"
            d = self.cbm(p + ".down", h, 2)
            a, b = self.cbm(p + ".part_a", d), self.cbm(p + ".part_b", d)
            for r in range(n):
                q = f"{p}.blocks.{r}"
                b = b + self.cbm(q + ".expand", self.cbm(q + ".reduce", b))
            h = self.cbm(p + ".fuse",
                         torch.cat([self.cbm(p + ".transition", b), a], 1))
            taps.append(h)
        return taps[2:]

    def seq(self, name, x, n):
        for k in range(n):
            x = self.block(f"{name}.{k}", x)
        return x

    def head(self, s, h):
        h = self.block("head" + s, h)
        y = F.conv2d(h, self.sd[f"out{s}.weight"], self.sd[f"out{s}.bias"])
        n, c, hg, wg = y.shape
        return y.permute(0, 2, 3, 1).reshape(n, hg, wg, 3, c // 3)

    def __call__(self, images_u8):
        """[N, H, W, 3] uint8 -> (y32, y16, y8), [N, Hg, Wg, 3, 5 + C]."""
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")  # noqa: E731
        with torch.no_grad(), ieee_f32():
            x = images_u8.permute(0, 3, 1, 2).float() / 255.0
            c3, c4, c5 = self.backbone(x)
            p5 = self.seq("spp.pre", c5, 3)
            p5 = torch.cat([F.max_pool2d(p5, k, 1, k // 2) for k in (13, 9, 5)]
                           + [p5], 1)
            p5 = self.seq("spp.post", p5, 3)
            p4 = self.seq("five16", torch.cat(
                [self.block("lateral16", c4), up(self.block("reduce16", p5))], 1), 5)
            p3 = self.seq("five8", torch.cat(
                [self.block("lateral8", c3), up(self.block("reduce8", p4))], 1), 5)
            y8 = self.head("8", p3)
            n4 = self.seq("bottom16", torch.cat([self.block("down16", p3, 2), p4], 1), 5)
            y16 = self.head("16", n4)
            n5 = self.seq("bottom32", torch.cat([self.block("down32", n4, 2), p5], 1), 5)
            return self.head("32", n5), y16, y8


def decode(heads, image_hw, anchors, scale_x_y=SCALE_X_Y):
    """(y32, y16, y8) -> (boxes [N, G, 4], conf [N, G], scores [N, G, C]),
    heads coarsest first, then row-major cells, then anchors."""
    h, w = image_hw
    out = []
    for s, (y, k) in enumerate(zip(heads, scale_x_y)):
        y = y.float()
        n, hg, wg, a, _ = y.shape
        grp = torch.tensor(anchors[6 - 3 * s:9 - 3 * s], dtype=torch.float32)
        cy = torch.arange(hg, dtype=torch.float32).view(1, hg, 1, 1)
        cx = torch.arange(wg, dtype=torch.float32).view(1, 1, wg, 1)
        bx = (torch.sigmoid(y[..., 0]) * k - (k - 1) / 2 + cx) * (w / wg)
        by = (torch.sigmoid(y[..., 1]) * k - (k - 1) / 2 + cy) * (h / hg)
        bw = grp[:, 0] * torch.exp(y[..., 2])
        bh = grp[:, 1] * torch.exp(y[..., 3])
        boxes = torch.stack([bx - bw / 2, by - bh / 2, bx + bw / 2, by + bh / 2], -1)
        conf = torch.sigmoid(y[..., 4])
        scores = torch.sigmoid(y[..., 5:]) * conf[..., None]
        g = hg * wg * a
        out.append((boxes.reshape(n, g, 4), conf.reshape(n, g),
                    scores.reshape(n, g, -1)))
    return tuple(torch.cat(t, 1) for t in zip(*out))


def _iou(a, b):
    ix = (torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0])).clamp(min=0)
    iy = (torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1])).clamp(min=0)
    inter = ix * iy
    area = lambda t: (t[..., 2] - t[..., 0]) * (t[..., 3] - t[..., 1])  # noqa: E731
    return inter / (area(a) + area(b) - inter)


def nms(boxes, conf, scores, conf_thre, iou_thre, max_keep):
    """Greedy class-agnostic NMS of each image's ``max_keep`` most confident
    candidates at or above ``conf_thre`` -> (boxes, labels, keep), best
    first."""
    k = min(max_keep, conf.shape[1])
    order = torch.sort(torch.where(conf >= conf_thre, conf, -1.0), dim=1,
                       descending=True, stable=True).indices[:, :k]
    keep = (conf >= conf_thre).gather(1, order)
    b = boxes.gather(1, order[..., None].expand(-1, -1, 4))
    over = _iou(b[:, :, None], b[:, None, :]) >= iou_thre
    for i in range(k):
        later = torch.arange(k) > i
        keep = keep & ~(over[:, i] & later & keep[:, i:i + 1])
    labels = scores.gather(1, order[..., None].expand(-1, -1, scores.shape[-1])).argmax(-1)
    return b, labels, keep
