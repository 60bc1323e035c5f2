"""Batched on-device augmentation with bbox transforms.

Port of ``odc_tpu/ops/augment.py``.  The reference composes six
albumentations transforms, each applied with p=0.5: RandomScale ±20%,
Affine translate ±20%, Affine rotate ±45°, OneOf(HFlip, VFlip),
ChannelShuffle, HueSaturationValue.  Here all geometric transforms compose
into ONE affine matrix per image and execute as a single warp over the
fixed-size batch; color transforms are elementwise passes.  Everything runs
on the batch's device inside the train step.

Sampling is split from application: :func:`sample_augment_params` draws one
:class:`AugmentParams` per batch from a ``torch.Generator``;
:func:`apply_augment` is deterministic given the parameters, which is what
the parity tests against the JAX package feed both sides;
:func:`augment_batch` calls both.

Behavioral notes (the JAX package's, kept):

* boxes follow the enclosing-axis-aligned-box rule for rotated corners and
  are clipped to the canvas; degenerate boxes are invalidated;
* RandomScale is a zoom about the center of the fixed canvas;
* translate-x and translate-y share one coin;
* HueSaturationValue uses OpenCV conventions: hue shift ±20 in OpenCV's
  0-179 half-degree units, saturation/value shifts ±30/±20 in uint8 units;
* the geometric backend is the two-pass warp (``ops/warp.py``): exact
  bilinear for axis-aligned transforms, one interpolation per pass for
  rotations.  ``"auto"`` is the CUDA kernel for CUDA tensors and the plain
  two-pass version for CPU tensors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    p_scale: float = 0.5
    scale_limit: Tuple[float, float] = (-0.2, 0.2)
    p_translate: float = 0.5
    translate_limit: Tuple[float, float] = (-0.2, 0.2)
    p_rotate: float = 0.5
    rotate_limit: Tuple[float, float] = (-45.0, 45.0)
    p_flip: float = 0.5          # OneOf(HFlip, VFlip)
    p_channel_shuffle: float = 0.5
    p_hsv: float = 0.5
    hue_shift_limit: float = 20.0   # OpenCV half-degree units
    sat_shift_limit: float = 30.0   # uint8 units
    val_shift_limit: float = 20.0   # uint8 units


class AugmentParams(NamedTuple):
    """One batch's sampled augmentation."""

    ms: torch.Tensor      # [B, 3, 3] f32 forward affine, input -> output px
    perm: torch.Tensor    # [B, 3] int64 channel permutation (identity: 0 1 2)
    do_hsv: torch.Tensor  # [B] bool
    dh: torch.Tensor      # [B] f32 hue shift, OpenCV half-degrees
    ds: torch.Tensor      # [B] f32 saturation shift, uint8 units
    dv: torch.Tensor      # [B] f32 value shift, uint8 units


def affine_matrices(scale, tx, ty, theta, fx, fy, hw) -> torch.Tensor:
    """Forward matrices [B, 3, 3] about the canvas center from per-image
    scale, translation (pixels), rotation (radians) and flip signs:
    ``M = T(center) @ Translate @ Rotate @ Scale @ Flip @ T(-center)``."""
    h, w = hw
    cos, sin = torch.cos(theta), torch.sin(theta)
    a = scale * cos * fx
    b = -scale * sin * fy
    c = scale * sin * fx
    d = scale * cos * fy
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    zero, one = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack(
        [
            a, b, cx + tx - a * cx - b * cy,
            c, d, cy + ty - c * cx - d * cy,
            zero, zero, one,
        ],
        dim=-1,
    ).view(-1, 3, 3)


def sample_augment_params(
    generator: torch.Generator,
    b: int,
    cfg: AugmentConfig,
    hw: Tuple[int, int],
    device,
) -> AugmentParams:
    """Draw one batch of augmentation parameters on ``device`` (the
    generator's device)."""
    h, w = hw
    u = torch.rand(b, 17, generator=generator, device=device)

    def between(col, lo, hi):
        return lo + (hi - lo) * u[:, col]

    def maybe(col, p, value, default):
        return torch.where(
            u[:, col] < p, value, torch.full_like(value, default)
        )

    scale = maybe(0, cfg.p_scale, 1.0 + between(1, *cfg.scale_limit), 1.0)
    # One coin for both translations.
    tx = maybe(4, cfg.p_translate, between(2, *cfg.translate_limit) * w, 0.0)
    ty = maybe(4, cfg.p_translate, between(3, *cfg.translate_limit) * h, 0.0)
    theta = maybe(
        5, cfg.p_rotate, torch.deg2rad(between(6, *cfg.rotate_limit)), 0.0
    )
    do_flip = u[:, 7] < cfg.p_flip
    flip_h = u[:, 8] < 0.5  # OneOf: HFlip else VFlip
    fx = torch.where(do_flip & flip_h, -1.0, 1.0)
    fy = torch.where(do_flip & ~flip_h, -1.0, 1.0)
    ms = affine_matrices(scale, tx, ty, theta, fx, fy, hw)

    # ChannelShuffle: a uniform random permutation of RGB, or the identity.
    perm = torch.argsort(u[:, 9:12], dim=-1)
    identity = torch.arange(3, device=device).expand(b, 3)
    perm = torch.where(
        (u[:, 12] < cfg.p_channel_shuffle)[:, None], perm, identity
    )
    return AugmentParams(
        ms=ms,
        perm=perm,
        do_hsv=u[:, 13] < cfg.p_hsv,
        dh=between(14, -cfg.hue_shift_limit, cfg.hue_shift_limit),
        ds=between(15, -cfg.sat_shift_limit, cfg.sat_shift_limit),
        dv=between(16, -cfg.val_shift_limit, cfg.val_shift_limit),
    )


def warp_max_shear(cfg: AugmentConfig) -> float:
    """Static bound on the two-pass warp's translation slopes for ``cfg``.

    For the scale·rotation·flip family the pass-X slope is ``q1 = b/d =
    ±tan(theta)`` and the pass-Y slope is ``c = ∓sin(theta)/s``, so the
    bound is ``max(tan(theta_max), sin(theta_max)/s_min)``.  The
    decomposition needs ``|d| = cos(theta)/s`` bounded away from 0: beyond
    45° the per-row translation would be clipped and the geometry wrong, so
    it is rejected here; larger rotations require ``warp_impl="oneshot"``.
    """
    theta = (
        max(abs(cfg.rotate_limit[0]), abs(cfg.rotate_limit[1]))
        if cfg.p_rotate > 0.0 else 0.0
    )
    if theta > 45.0:
        raise ValueError(
            f"two-pass warp backends support |rotation| <= 45 deg "
            f"(got rotate_limit={cfg.rotate_limit}); use warp_impl='oneshot' "
            f"for larger rotations"
        )
    s_min = 1.0 + min(cfg.scale_limit[0], 0.0)
    if s_min <= 0.0:
        raise ValueError(f"scale_limit lower bound must be > -1 "
                         f"(got {cfg.scale_limit})")
    t = math.radians(theta)
    return max(math.tan(t), math.sin(t) / s_min)


def _invert_affine(ms: torch.Tensor) -> torch.Tensor:
    """Inverse of affine matrices [B, 3, 3] whose last row is (0, 0, 1), in
    closed form."""
    a, b, e = ms[:, 0, 0], ms[:, 0, 1], ms[:, 0, 2]
    c, d, f = ms[:, 1, 0], ms[:, 1, 1], ms[:, 1, 2]
    det = a * d - b * c
    zero, one = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack(
        [
            d / det, -b / det, (b * f - d * e) / det,
            -c / det, a / det, (c * e - a * f) / det,
            zero, zero, one,
        ],
        dim=-1,
    ).view(-1, 3, 3)


def _warp_images(imgs, m_invs, hw, impl: str, max_shear: float = 1.0):
    """Batched warp dispatch of uint8 (or f32) images, f32 out.  ``impl``:

    * ``"auto"`` (default): ``"kernel"`` for CUDA tensors, ``"twopass"``
      for CPU tensors;
    * ``"kernel"``: the two-pass warp through ``ops/cuda/warp_kernel.py``,
      which reads the images as they are (the CUDA kernel converts uint8
      in registers; for CPU tensors its wrapper runs the plain version);
    * ``"twopass"``: the plain two-pass warp (``ops/warp.py``) on any
      device;
    * ``"oneshot"``: direct 4-tap bilinear gather — single-resample
      semantics, the oracle for axis-aligned transforms.
    """
    from odc_tpu_torch.ops.warp import warp_affine_oneshot, warp_affine_twopass

    if impl == "auto":
        impl = "kernel" if imgs.device.type == "cuda" else "twopass"
    if impl == "kernel":
        from odc_tpu_torch.ops.cuda.warp_kernel import warp_affine

        return warp_affine(imgs, m_invs, max_shear=max_shear)
    imgs = imgs.float()
    if impl == "twopass":
        return warp_affine_twopass(imgs, m_invs, hw, max_shear)
    if impl == "oneshot":
        return warp_affine_oneshot(imgs, m_invs, hw)
    raise ValueError(f"unknown warp impl {impl!r}")


def _warp_boxes(boxes, valid, ms, hw):
    """Forward-transform corners [B, M, 4] by ``ms`` [B, 3, 3], take the
    enclosing box, clip, re-validate."""
    h, w = hw
    x1, y1, x2, y2 = boxes.unbind(-1)
    corners_x = torch.stack([x1, x2, x1, x2], -1)  # [B, M, 4]
    corners_y = torch.stack([y1, y1, y2, y2], -1)
    m = ms[:, None, None]  # [B, 1, 1, 3, 3]
    nx = m[..., 0, 0] * corners_x + m[..., 0, 1] * corners_y + m[..., 0, 2]
    ny = m[..., 1, 0] * corners_x + m[..., 1, 1] * corners_y + m[..., 1, 2]
    out = torch.stack(
        [nx.amin(-1), ny.amin(-1), nx.amax(-1), ny.amax(-1)], -1
    )
    hi = torch.tensor([w, h, w, h], dtype=out.dtype, device=out.device)
    out = torch.minimum(out.clamp(min=0.0), hi)
    ok = (out[..., 2] - out[..., 0] > 1.0) & (out[..., 3] - out[..., 1] > 1.0)
    return out, valid & ok


def _rgb_to_hsv(rgb):
    """RGB [0,255] float -> (h in [0,180) OpenCV units, s, v in [0,255])."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn
    safe_d = torch.where(d == 0, torch.ones_like(d), d)
    hr = torch.remainder((g - b) / safe_d, 6.0)
    hg = (b - r) / safe_d + 2.0
    hb = (r - g) / safe_d + 4.0
    hh = torch.where(mx == r, hr, torch.where(mx == g, hg, hb))
    hh = torch.where(d == 0, torch.zeros_like(hh), hh) * 30.0  # 0-180
    s = torch.where(
        mx == 0, torch.zeros_like(d), d / torch.where(mx == 0, torch.ones_like(mx), mx)
    ) * 255.0
    return hh, s, mx


def _hsv_to_rgb(hh, s, v):
    hh = torch.remainder(hh, 180.0) / 30.0  # [0, 6)
    s = s.clamp(0.0, 255.0) / 255.0
    v = v.clamp(0.0, 255.0)
    i = torch.floor(hh)
    f = hh - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = i.to(torch.int32)

    def select(c0, c1, c2, c3, c4, c5):
        out = c5
        for k, c in ((4, c4), (3, c3), (2, c2), (1, c1), (0, c0)):
            out = torch.where(i == k, c, out)
        return out

    r = select(v, q, p, p, t, v)
    g = select(t, v, v, q, p, p)
    b = select(p, p, t, v, v, q)
    return torch.stack([r, g, b], -1)


def _color(img, params: AugmentParams):
    """ChannelShuffle then HueSaturationValue on [B, H, W, 3] f32 images."""
    b, h, w, _ = img.shape
    img = torch.gather(img, -1, params.perm.view(b, 1, 1, 3).expand(b, h, w, 3))

    def per_image(x):
        return x.view(b, 1, 1)

    hh, s, v = _rgb_to_hsv(img)
    shifted = _hsv_to_rgb(
        hh + per_image(params.dh),
        s + per_image(params.ds),
        v + per_image(params.dv),
    )
    return torch.where(params.do_hsv.view(b, 1, 1, 1), shifted, img)


def apply_augment(
    images: torch.Tensor,  # [B, H, W, 3] uint8
    boxes: torch.Tensor,   # [B, M, 4] f32 pixel corners
    valid: torch.Tensor,   # [B, M] bool
    params: AugmentParams,
    cfg: AugmentConfig = AugmentConfig(),
    warp_impl: str = "auto",
):
    """Apply sampled parameters to the batch.  Returns (images uint8, boxes
    f32, valid).  ``warp_impl``: see :func:`_warp_images`."""
    hw = tuple(images.shape[1:3])
    m_invs = _invert_affine(params.ms)
    # Derived (not hardcoded) slope bound: validates rotate_limit for the
    # two-pass backends and shrinks the shift range for small rotations.
    max_shear = warp_max_shear(cfg) if warp_impl != "oneshot" else 1.0
    imgf = _warp_images(images, m_invs, hw, warp_impl, max_shear)
    imgf = _color(imgf, params)
    out_boxes, out_valid = _warp_boxes(boxes, valid, params.ms, hw)
    return imgf.clamp(0, 255).to(torch.uint8), out_boxes, out_valid


def augment_batch(
    generator: torch.Generator,
    images: torch.Tensor,
    boxes: torch.Tensor,
    valid: torch.Tensor,
    cfg: AugmentConfig = AugmentConfig(),
    warp_impl: str = "auto",
    dp=None,
):
    """One augmentation pass over the batch: sample, then apply.

    Data parallelism (``dp``, a ``parallel.DataParallel``): the batch is
    this rank's contiguous slice of the global batch, so the parameters are
    drawn for the GLOBAL batch from the same-seeded generator on every
    rank, and the rank keeps its rows; each image is augmented as the
    one-process step would augment it."""
    b = images.shape[0]
    world, rank = (1, 0) if dp is None else (dp.world_size, dp.rank)
    params = sample_augment_params(
        generator, b * world, cfg, tuple(images.shape[1:3]), images.device,
    )
    if world > 1:
        params = AugmentParams(*(f[rank * b:(rank + 1) * b] for f in params))
    return apply_augment(images, boxes, valid, params, cfg, warp_impl)
