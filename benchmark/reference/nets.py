"""Plain float32 YOLOv2 and YOLOv3 forwards, from a state dict.

The benchmark's own reference: NCHW ``F.conv2d`` with the unfolded
BatchNorm, LeakyReLU(0.1) and max pools, written from the papers
(YOLO9000, arXiv:1612.08242; YOLOv3, arXiv:1804.02767) and the layer list
in the configuration file.  It imports nothing of the program.  Parameter
names follow the program's checkpoint layout so one state dict feeds both.

``conv`` is the convolution every layer calls, ``conv(x, w, b, stride,
pad)`` with ``pad = (left, right, top, bottom)``: :func:`conv_f32` for the
reference, :func:`conv_fp8` for the lower-precision control.  BatchNorm
uses the running statistics; ``on_bn``, when given, is called with
``(name, pre-BN activation)`` before every BatchNorm (the calibration
hooks in there).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BN_EPS = 1e-5
LEAKY = 0.1


def conv_f32(x, w, b, stride, pad):
    """Float32 convolution; the caller turns TF32 off."""
    if any(pad):
        x = F.pad(x, pad)
    return F.conv2d(x.float(), w.float(), None if b is None else b.float(),
                    stride=stride)


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one per-tensor scale (amax -> 448)."""
    scale = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def conv_fp8(x, w, b, stride, pad):
    """The control, float8 inference's recipe: the convolution's input and
    weight rounded to e4m3 (per-tensor scales), products summed in float32,
    the bias kept."""
    if any(pad):
        x = F.pad(x, pad)
    return F.conv2d(_fp8(x.float()), _fp8(w.float()),
                    None if b is None else b.float(), stride=stride)


def same_pad(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one axis: the low side gets the smaller half."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC RGB -> ImageNet-normalized float32 NCHW."""
    mean = torch.tensor(IMAGENET_MEAN, device=images_u8.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=images_u8.device).view(1, 3, 1, 1)
    x = images_u8.permute(0, 3, 1, 2).float() / 255.0
    return (x - mean) / std


class Net:
    """Shared machinery: a state dict, a conv, BatchNorm on running
    statistics."""

    def __init__(self, sd: Dict[str, torch.Tensor], conv: Callable = conv_f32,
                 on_bn: Optional[Callable[[str, torch.Tensor], None]] = None):
        self.sd = sd
        self.conv = conv
        self.on_bn = on_bn

    def bn(self, name: str, x: torch.Tensor) -> torch.Tensor:
        if self.on_bn is not None:
            self.on_bn(name, x)
        w, b = self.sd[name + ".weight"], self.sd[name + ".bias"]
        mean, var = self.sd[name + ".running_mean"], self.sd[name + ".running_var"]
        y = (x - mean.view(1, -1, 1, 1)) * torch.rsqrt(var.view(1, -1, 1, 1) + BN_EPS)
        return y * w.view(1, -1, 1, 1) + b.view(1, -1, 1, 1)

    def cbl(self, name: str, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
        """Conv (SAME) + BatchNorm + LeakyReLU(0.1)."""
        w = self.sd[name + ".conv.weight"]
        k = w.shape[-1]
        (t, bo), (l, r) = same_pad(x.shape[2], k, stride), same_pad(x.shape[3], k, stride)
        y = self.conv(x, w, self.sd[name + ".conv.bias"], stride, (l, r, t, bo))
        return F.leaky_relu(self.bn(name + ".bn", y), LEAKY)

    def plain_conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """A 1x1 conv with bias (the heads)."""
        return self.conv(x, self.sd[name + ".weight"], self.sd[name + ".bias"],
                         1, (0, 0, 0, 0))


def _head_nhwc(y: torch.Tensor, anchors: int) -> torch.Tensor:
    """[N, A * (5 + C), Hg, Wg] -> [N, Hg, Wg, A, 5 + C]."""
    n, ch, hg, wg = y.shape
    return y.permute(0, 2, 3, 1).reshape(n, hg, wg, anchors, ch // anchors)


class YOLOv2Ref(Net):
    """Darknet-19 (stages from the configuration), the quadrant-stack neck
    (c5's TL/TR/BL/BR quadrants on channels, then c7: 3072 channels), a
    3x3 conv to 1024 and a 1x1 head of A x (5 + C)."""

    def __init__(self, cfg: dict, sd, **kw):
        super().__init__(sd, **kw)
        self.stages = cfg["darknet19_stages"]
        self.anchors = len(cfg["anchors"])

    def forward(self, images_u8: torch.Tensor) -> torch.Tensor:
        h = normalize(images_u8)
        c5 = None
        for i, stage in enumerate(self.stages):
            if 1 <= i <= 5:
                h = F.max_pool2d(h, 2)
            for j in range(len(stage)):
                h = self.cbl(f"backbone.stages.{i}.{j}", h)
            if i == 4:
                c5 = h
        hh, ww = c5.shape[2] // 2, c5.shape[3] // 2
        quads = [c5[:, :, :hh, :ww], c5[:, :, :hh, ww:2 * ww],
                 c5[:, :, hh:2 * hh, :ww], c5[:, :, hh:2 * hh, ww:2 * ww]]
        h = self.cbl("neck", torch.cat(quads + [h], dim=1))
        return _head_nhwc(self.plain_conv("head", h), self.anchors)


def upsample2(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class YOLOv3Ref(Net):
    """Darknet-53 (SAME stride-2 downsamples, residual 1x1 -> 3x3 blocks),
    the three-scale FPN (the paper's concat merges: a 1x1 conv over
    ``[upsample2(reduce(p)), tap]``) and three 3x3 + 1x1 heads, coarsest
    first."""

    def __init__(self, cfg: dict, sd, **kw):
        super().__init__(sd, **kw)
        self.blocks = cfg["darknet53_blocks"]

    def merge(self, name: str, r: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        w = torch.cat([self.sd[name + ".conv_r.weight"],
                       self.sd[name + ".conv_c.weight"]], dim=1)
        y = self.conv(torch.cat([upsample2(r), c], dim=1), w,
                      self.sd[name + ".conv_r.bias"], 1, (0, 0, 0, 0))
        return F.leaky_relu(self.bn(name + ".bn", y), LEAKY)

    def five(self, name: str, h: torch.Tensor, n: int) -> torch.Tensor:
        for k in range(n):
            h = self.cbl(f"{name}.layers.{k}", h)
        return h

    def head(self, s: str, h: torch.Tensor) -> torch.Tensor:
        return _head_nhwc(self.plain_conv("out" + s, self.cbl("head" + s, h)), 3)

    def forward(self, images_u8: torch.Tensor):
        h = self.cbl("backbone.stem", normalize(images_u8))
        taps = []
        for i, (_, repeat) in enumerate(self.blocks):
            h = self.cbl(f"backbone.stages.{i}.0", h, stride=2)
            for r in range(repeat):
                pre = f"backbone.stages.{i}.{r + 1}"
                h = h + self.cbl(pre + ".expand", self.cbl(pre + ".reduce", h))
            taps.append(h)
        c3, c4, c5 = taps[2], taps[3], taps[4]
        p5 = self.five("five32", c5, 5)
        y32 = self.head("32", p5)
        p4 = self.five("five16", self.merge("merge16", self.cbl("reduce16", p5), c4), 4)
        y16 = self.head("16", p4)
        p3 = self.five("five8", self.merge("merge8", self.cbl("reduce8", p4), c3), 4)
        y8 = self.head("8", p3)
        return y32, y16, y8


NETS = {"YOLOv2": YOLOv2Ref, "YOLOv3": YOLOv3Ref}


def net(cfg: dict, sd, **kw) -> Net:
    return NETS[cfg["model"]](cfg, sd, **kw)


# ----------------------------------------------------------------------------
# Parameter layout (the program's checkpoint names) and seeded weights.


def _bn(name: str, c: int) -> List[tuple]:
    return [(name + ".weight", (c,), "gamma"), (name + ".bias", (c,), "beta"),
            (name + ".running_mean", (c,), "zero"),
            (name + ".running_var", (c,), "one")]


def _cbl(name: str, cin: int, cout: int, k: int) -> List[tuple]:
    return ([(name + ".conv.weight", (cout, cin, k, k), "w"),
             (name + ".conv.bias", (cout,), "b")] + _bn(name + ".bn", cout))


def _conv(name: str, cin: int, cout: int, bias: bool = True) -> List[tuple]:
    out = [(name + ".weight", (cout, cin, 1, 1), "w")]
    return out + ([(name + ".bias", (cout,), "b")] if bias else [])


def param_specs(cfg: dict) -> List[tuple]:
    """``(name, shape, kind)`` of every tensor of the configuration, in a
    fixed order; ``kind`` is ``w``/``b`` (uniform in +-1/sqrt(fan_in) of
    the conv), ``gamma``/``beta`` (BatchNorm's scale and shift) or
    ``one``/``zero`` (the running statistics)."""
    nc = cfg["num_cls"]
    out: List[tuple] = []
    if cfg["model"] == "YOLOv2":
        cin = 3
        for i, stage in enumerate(cfg["darknet19_stages"]):
            for j, (f, k) in enumerate(stage):
                out += _cbl(f"backbone.stages.{i}.{j}", cin, f, k)
                cin = f
        c5 = cfg["darknet19_stages"][4][-1][0]
        out += _cbl("neck", 4 * c5 + cin, cfg["neck_features"], 3)
        out += _conv("head", cfg["neck_features"], len(cfg["anchors"]) * (5 + nc))
        return out
    a = 3 * (5 + nc)
    out += _cbl("backbone.stem", 3, 32, 3)
    cin = 32
    for i, (f, repeat) in enumerate(cfg["darknet53_blocks"]):
        out += _cbl(f"backbone.stages.{i}.0", cin, f, 3)
        for r in range(repeat):
            out += _cbl(f"backbone.stages.{i}.{r + 1}.reduce", f, f // 2, 1)
            out += _cbl(f"backbone.stages.{i}.{r + 1}.expand", f // 2, f, 3)
        cin = f

    def five(name, cin, f, first):
        plan = [(1, f), (3, 2 * f), (1, f), (3, 2 * f), (1, f)]
        res = []
        for k, (ks, co) in enumerate(plan if first else plan[1:]):
            res += _cbl(f"{name}.layers.{k}", cin, co, ks)
            cin = co
        return res

    out += five("five32", 1024, 512, True)
    out += _cbl("head32", 512, 1024, 3) + _conv("out32", 1024, a)
    out += _cbl("reduce16", 512, 256, 1)
    out += _conv("merge16.conv_r", 256, 256) + _conv("merge16.conv_c", 512, 256, False)
    out += _bn("merge16.bn", 256)
    out += five("five16", 256, 256, False)
    out += _cbl("head16", 256, 512, 3) + _conv("out16", 512, a)
    out += _cbl("reduce8", 256, 128, 1)
    out += _conv("merge8.conv_r", 128, 128) + _conv("merge8.conv_c", 256, 128, False)
    out += _bn("merge8.bn", 128)
    out += five("five8", 128, 128, False)
    out += _cbl("head8", 128, 256, 3) + _conv("out8", 256, a)
    return out


# BatchNorm's scale and shift, drawn: U(0.75, 1.25) and U(0.5, 1.5).  A
# shift around +1 keeps most of each LeakyReLU's inputs on its linear side;
# at a zero shift the random network amplifies rounding about five times
# more (bf16 lies 14% from f32 at YOLOv2's head instead of 3%), and a
# float8 control lies within 2-3x of bf16 on every detection number.
BN_DRAWS = {"gamma": (0.75, 1.25), "beta": (0.5, 1.5)}


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Float32 weights from ``seed``: one uniform draw on ``device`` for
    every conv weight and bias (PyTorch's default conv bound 1/sqrt(fan_in)
    of the layer; a bias takes its conv's bound) and every BatchNorm scale
    and shift (:data:`BN_DRAWS`); running statistics at identity."""
    specs = param_specs(cfg)
    drawn = [s for s in specs if s[2] in ("w", "b") or s[2] in BN_DRAWS]
    total = sum(math.prod(shape) for _, shape, _ in drawn)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(total, generator=gen, device=device)
    sd, off, fan_in = {}, 0, 1
    for name, shape, kind in specs:
        n = math.prod(shape)
        if kind in ("w", "b"):
            if kind == "w":
                fan_in = math.prod(shape[1:])
            bound = 1.0 / math.sqrt(fan_in)
            sd[name] = flat[off:off + n].view(shape).mul(2 * bound).sub(bound)
            off += n
        elif kind in BN_DRAWS:
            lo, hi = BN_DRAWS[kind]
            sd[name] = flat[off:off + n].view(shape).mul(hi - lo).add(lo)
            off += n
        else:
            sd[name] = torch.full(shape, 1.0 if kind == "one" else 0.0,
                                  device=device)
    return sd


def param_count(cfg: dict) -> int:
    """Trainable parameters (BatchNorm running statistics excluded)."""
    return sum(math.prod(shape) for name, shape, _ in param_specs(cfg)
               if not name.endswith(("running_mean", "running_var")))
