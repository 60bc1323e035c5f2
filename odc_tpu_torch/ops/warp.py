"""Affine image warps with zero fill, batched over ``[B, H, W, C]``.

Port of ``odc_tpu/ops/warp.py``.  Two functions with different semantics:

* :func:`warp_affine_oneshot` — inverse-mapped bilinear warp, one resample:
  ``out(x) = in(m_inv @ x)`` with 4 taps per output pixel;
* :func:`warp_affine_twopass` — the Catmull-Smith two-pass decomposition
  the JAX package trains with.  Any affine inverse map

      sx = a·x + b·y + e,   sy = c·x + d·y + f

  factors (for ``d != 0``) into a horizontal pass then a vertical pass,

      pass X:  tmp[y, xo] = in[y,  p·xo + q1·y + q0]     p = (ad - bc)/d
      pass Y:  out[yo, x] = tmp[d·yo + c·x + f,  x]      q1 = b/d, q0 = e - q1·f

  and each pass chains two linear interpolations: a per-row fractional
  translation by ``tau = q1·(y - cy)`` (a 2-tap blend with the neighbor,
  then an integer shift), and a constant-slope resample with the
  interpolation-hat matrix.  That is a 3-tap filter per pass whenever the
  shear is non-zero, so rotations differ from the one-shot warp; for
  axis-aligned maps (``b = c = 0``) the two agree.

This module is the step-by-step port (pad, blend, barrel shifter of rolls,
hat-matrix product) and serves as the plain version of the CUDA kernel in
``ops/cuda/warp_kernel.py``, which reads the source taps directly.  All
arithmetic is float32.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F


def warp_affine_oneshot(
    images: torch.Tensor, m_invs: torch.Tensor, hw: Tuple[int, int]
) -> torch.Tensor:
    """Bilinear warp with zero fill: images [B, H, W, C] f32, m_invs
    [B, 3, 3] -> [B, H, W, C].  The semantic oracle for axis-aligned maps."""
    h, w = hw
    b = images.shape[0]
    dev = images.device
    ys = torch.arange(h, dtype=torch.float32, device=dev).view(1, h, 1)
    xs = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, w)
    m = m_invs.view(b, 9, 1, 1)
    sx = m[:, 0] * xs + m[:, 1] * ys + m[:, 2]
    sy = m[:, 3] * xs + m[:, 4] * ys + m[:, 5]

    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    bi = torch.arange(b, device=dev).view(b, 1, 1)

    def tap(yi, xi):
        inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        xi_c = xi.clamp(0, w - 1).long()
        yi_c = yi.clamp(0, h - 1).long()
        v = images[bi, yi_c, xi_c]  # [B, H, W, C]
        return torch.where(inside[..., None], v, torch.zeros((), device=dev))

    v00 = tap(y0, x0)
    v01 = tap(y0, x0 + 1)
    v10 = tap(y0 + 1, x0)
    v11 = tap(y0 + 1, x0 + 1)
    top = v00 + (v01 - v00) * fx
    bot = v10 + (v11 - v10) * fx
    return top + (bot - top) * fy


def twopass_coeffs(m_invs: torch.Tensor, hw: Tuple[int, int]):
    """Pass coefficients from the inverse maps [..., 3, 3].

    Returns ``(p, mx0, q1, d, my0, c)``, each [...]: pass X samples at
    ``p·xo + mx0 + q1·(y - cy)``; pass Y at ``d·yo + my0 + c·(x - cx)``
    (cy, cx the center offsets already folded into mx0/my0)."""
    h, w = hw
    a, b, e = m_invs[..., 0, 0], m_invs[..., 0, 1], m_invs[..., 0, 2]
    c, d, f = m_invs[..., 1, 0], m_invs[..., 1, 1], m_invs[..., 1, 2]
    # |d| >= 0.59 for the augmentation family (|theta| <= 45 deg, scale <=
    # 1.2); clamp for numerical safety on degenerate user-supplied maps.
    sign = torch.where(d < 0, -1e-3, 1e-3).to(d.dtype)
    d_safe = torch.where(d.abs() < 1e-3, sign, d)
    q1 = b / d_safe
    p = a - q1 * c
    q0 = e - q1 * f
    cy = (h - 1) / 2.0
    cx = (w - 1) / 2.0
    mx0 = q0 + q1 * cy
    my0 = f + c * cx
    return p, mx0, q1, d, my0, c


def shift_kmax(n: int, max_shear: float = 1.0) -> int:
    """Static bound on the per-row integer translation: |q1|, |c| <=
    max_shear (1.0 covers |theta| <= 45 deg), offsets span
    max_shear·(n-1)/2 around the center."""
    return int(math.ceil(max_shear * (n - 1) / 2.0))


# Extra lanes beyond 2*kmax on the extended axis: every position the hat
# resample can read from inside the canvas stays within the extension.
_PAD_MARGIN = 4


def ext_size(n: int, kmax: int) -> int:
    return n + 2 * kmax + _PAD_MARGIN


def hat_matrix(n_in: int, n_out: int, slope, offset) -> torch.Tensor:
    """Interpolation matrices M[..., i, o] = hat(slope·o + offset - i) for
    ``slope``/``offset`` of shape [...]: multiplying by one resamples a
    length-``n_in`` axis at positions ``slope·o + offset`` with linear taps
    and zero fill (taps outside [0, n_in) have no row)."""
    dev = slope.device
    i = torch.arange(n_in, dtype=torch.float32, device=dev).view(n_in, 1)
    o = torch.arange(n_out, dtype=torch.float32, device=dev).view(1, n_out)
    pos = slope[..., None, None] * o + offset[..., None, None]
    return (1.0 - (pos - i).abs()).clamp(min=0.0)


def translate_axis_extended(
    v: torch.Tensor, tau: torch.Tensor, axis: int, kmax: int
) -> torch.Tensor:
    """Per-row real-valued translation of ``v`` [B, H, W, C] along ``axis``
    (1 or 2) with zero fill, |tau| <= kmax, as a fractional blend plus a
    barrel shifter of static rolls.

    Returns the extended array: ``out[j] = interp(v, (j - kmax) + tau_r)``
    for ``j`` in ``[0, ext_size(n, kmax))``.  ``tau`` must broadcast
    against ``v`` with size 1 on ``axis``."""
    tau = tau.clamp(-float(kmax), float(kmax))
    k = torch.floor(tau)
    frac = tau - k
    kp = k.to(torch.int32) + kmax  # in [0, 2*kmax]

    pad = [0, 0, 0, 0, 0, 0]  # (C, W, H) pairs, last dim first
    pad[2 * (3 - axis)] = 2 * kmax
    pad[2 * (3 - axis) + 1] = _PAD_MARGIN
    vp = F.pad(v, pad)

    # Fractional part: one 2-tap blend with the +1 neighbor.
    vp = vp + frac * (torch.roll(vp, -1, dims=axis) - vp)

    # Integer part: static power-of-2 rolls, taken per row through a mask.
    # out[j] = blended[j + kp_r].
    for bit in reversed(range(max(1, (2 * kmax).bit_length()))):
        s = 1 << bit
        vp = torch.where((kp & s) != 0, torch.roll(vp, -s, dims=axis), vp)

    # Lanes whose read index wrapped hold circular garbage; their source
    # positions are all in zero-fill territory.
    n_ext = vp.shape[axis]
    shape = [1, 1, 1, 1]
    shape[axis] = n_ext
    idx = torch.arange(n_ext, dtype=torch.int32, device=v.device).view(shape)
    return torch.where(idx + kp >= n_ext - 1, torch.zeros((), device=v.device), vp)


def warp_affine_twopass(
    images: torch.Tensor,
    m_invs: torch.Tensor,
    hw: Tuple[int, int],
    max_shear: float = 1.0,
) -> torch.Tensor:
    """Two-pass affine warp: images [B, H, W, C] f32, m_invs [B, 3, 3] ->
    [B, H, W, C] f32 (see the module docstring)."""
    h, w = hw
    b = images.shape[0]
    dev = images.device
    p, mx0, q1, d, my0, c = twopass_coeffs(m_invs.float(), hw)

    # Pass X: per-row translate by q1·(y-cy), then resample columns at
    # slope p from the extended canvas (+kx index offset).
    kx = shift_kmax(h, max_shear)
    y = torch.arange(h, dtype=torch.float32, device=dev).view(1, h, 1, 1)
    tau_x = q1.view(b, 1, 1, 1) * (y - (h - 1) / 2.0)
    v = translate_axis_extended(images, tau_x, axis=2, kmax=kx)
    mx = hat_matrix(ext_size(w, kx), w, p, mx0 + kx)  # [B, Wext, W]
    v = torch.einsum("bywc,bwx->byxc", v, mx)

    # Pass Y: per-column translate by c·(x-cx), then resample rows at
    # slope d.
    ky = shift_kmax(w, max_shear)
    x = torch.arange(w, dtype=torch.float32, device=dev).view(1, 1, w, 1)
    tau_y = c.view(b, 1, 1, 1) * (x - (w - 1) / 2.0)
    v = translate_axis_extended(v, tau_y, axis=1, kmax=ky)
    my = hat_matrix(ext_size(h, ky), h, d, my0 + ky)  # [B, Hext, H]
    return torch.einsum("byz,byxc->bzxc", my, v)
