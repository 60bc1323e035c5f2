"""Host-side augmentation in the reference's sequential order.

The port's own copy of ``odc_tpu/data/host_augment.py``: numpy on the host,
the same float64 arithmetic in the same order, so under one
``np.random.Generator`` seed it gives the JAX package's pixels, boxes and
labels bit for bit.

The device path (``odc_tpu_torch/ops/augment.py``) composes everything into
one fused warp on the fixed-size batch; this module is the host
alternative with the reference's exact *sequencing* (each transform applied
independently on the native canvas): RandomScale ±20% → Affine translate
±20% → Affine rotate ±45° → OneOf(HFlip, VFlip) → ChannelShuffle →
HueSaturationValue, each with p=0.5.  Plug into
``DetectionPipeline(augment=reference_augment)``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _resize(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    from odc_tpu_torch.native import loader as native_loader

    if native_loader.available():
        return native_loader.resize_bilinear(img, out_hw)
    from PIL import Image

    return np.asarray(
        Image.fromarray(img).resize((out_hw[1], out_hw[0]), Image.BILINEAR)
    )


def _affine_boxes(boxes: np.ndarray, m: np.ndarray, hw) -> Tuple[np.ndarray, np.ndarray]:
    """Forward-transform corners, enclose, clip; returns (boxes, keep)."""
    if not len(boxes):
        return boxes.reshape(-1, 4), np.zeros(0, bool)
    h, w = hw
    x1, y1, x2, y2 = boxes.T
    cx = np.stack([x1, x2, x1, x2], -1)
    cy = np.stack([y1, y1, y2, y2], -1)
    nx = m[0, 0] * cx + m[0, 1] * cy + m[0, 2]
    ny = m[1, 0] * cx + m[1, 1] * cy + m[1, 2]
    out = np.stack([nx.min(-1), ny.min(-1), nx.max(-1), ny.max(-1)], -1)
    out[:, 0::2] = np.clip(out[:, 0::2], 0, w)
    out[:, 1::2] = np.clip(out[:, 1::2], 0, h)
    keep = (out[:, 2] - out[:, 0] > 1) & (out[:, 3] - out[:, 1] > 1)
    return out, keep


def _warp(img: np.ndarray, m: np.ndarray) -> np.ndarray:
    """Inverse-mapped bilinear warp with zero fill (numpy, vectorized)."""
    h, w = img.shape[:2]
    m_inv = np.linalg.inv(m)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    sx = m_inv[0, 0] * xs + m_inv[0, 1] * ys + m_inv[0, 2]
    sy = m_inv[1, 0] * xs + m_inv[1, 1] * ys + m_inv[1, 2]
    x0 = np.floor(sx).astype(int)
    y0 = np.floor(sy).astype(int)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]

    def tap(yi, xi):
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        v = img[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)].astype(np.float64)
        return v * inside[..., None]

    top = tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx
    bot = tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx
    out = top * (1 - fy) + bot * fy
    return np.clip(out + 0.5, 0, 255).astype(np.uint8)


def _center_affine(a, b, c, d, tx, ty, hw) -> np.ndarray:
    h, w = hw
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    return np.array(
        [
            [a, b, cx + tx - a * cx - b * cy],
            [c, d, cy + ty - c * cx - d * cy],
            [0, 0, 1.0],
        ]
    )


def _rgb_hsv_shift(img, dh, ds, dv):
    """HSV shift in OpenCV conventions (hue 0-180 half-degrees)."""
    f = img.astype(np.float64)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    mx = f.max(-1)
    mn = f.min(-1)
    d = mx - mn
    sd = np.where(d == 0, 1, d)
    hh = np.where(
        mx == r, np.mod((g - b) / sd, 6),
        np.where(mx == g, (b - r) / sd + 2, (r - g) / sd + 4),
    )
    hh = np.where(d == 0, 0, hh) * 30.0 + dh
    s = np.clip(np.where(mx == 0, 0, d / np.where(mx == 0, 1, mx)) * 255 + ds, 0, 255)
    v = np.clip(mx + dv, 0, 255)

    hh = np.mod(hh, 180.0) / 30.0
    i = np.floor(hh).astype(int)
    fr = hh - i
    sl = s / 255.0
    p = v * (1 - sl)
    q = v * (1 - sl * fr)
    t = v * (1 - sl * (1 - fr))
    r = np.choose(i % 6, [v, q, p, p, t, v])
    g = np.choose(i % 6, [t, v, v, q, p, p])
    b = np.choose(i % 6, [p, p, t, v, v, q])
    return np.clip(np.stack([r, g, b], -1) + 0.5, 0, 255).astype(np.uint8)


def reference_augment(img, boxes, labels, rng: np.random.Generator):
    """AugmentFn for DetectionPipeline: reference transform order, p=0.5
    each, on the native canvas."""
    boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
    labels = np.asarray(labels)

    # 1. RandomScale ±20%: whole-canvas resize (boxes scale with it).
    if rng.random() < 0.5:
        f = 1.0 + rng.uniform(-0.2, 0.2)
        h, w = img.shape[:2]
        nh, nw = max(8, int(round(h * f))), max(8, int(round(w * f)))
        img = _resize(img, (nh, nw))
        boxes = boxes * [nw / w, nh / h, nw / w, nh / h]

    hw = img.shape[:2]

    # 2-4. translate / rotate / flip: independent warps (sequentially
    # composed into one to avoid triple resampling; geometry identical,
    # resampling slightly sharper than the reference's cascade).
    m = np.eye(3)
    if rng.random() < 0.5:  # translate
        tx = rng.uniform(-0.2, 0.2) * hw[1]
        ty = rng.uniform(-0.2, 0.2) * hw[0]
        m = _center_affine(1, 0, 0, 1, tx, ty, hw) @ m
    if rng.random() < 0.5:  # rotate
        th = np.deg2rad(rng.uniform(-45, 45))
        m = _center_affine(np.cos(th), -np.sin(th), np.sin(th), np.cos(th),
                           0, 0, hw) @ m
    if rng.random() < 0.5:  # OneOf(HFlip, VFlip)
        if rng.random() < 0.5:
            m = _center_affine(-1, 0, 0, 1, 0, 0, hw) @ m
        else:
            m = _center_affine(1, 0, 0, -1, 0, 0, hw) @ m

    if not np.allclose(m, np.eye(3)):
        img = _warp(img, m)
        boxes, keep = _affine_boxes(boxes, m, hw)
        boxes, labels = boxes[keep], labels[keep]

    # 5. ChannelShuffle.
    if rng.random() < 0.5:
        img = img[..., rng.permutation(3)]

    # 6. HueSaturationValue (OpenCV ranges ±20/±30/±20).
    if rng.random() < 0.5:
        img = _rgb_hsv_shift(
            img,
            rng.uniform(-20, 20),
            rng.uniform(-30, 30),
            rng.uniform(-20, 20),
        )

    return img, boxes, labels
