"""The port's device augmentation (``odc_tpu_torch.ops.augment``) against the
JAX package on the CPU.  JAX's random streams cannot be reproduced in torch,
so the application is held at the same parameters: the test replays
``augment_batch``'s draws from the JAX key and feeds them to
``apply_augment``.  The sampler is held statistically against
``AugmentConfig``."""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from odc_tpu.ops import augment as jaug
from odc_tpu_torch.ops import augment as taug
from torch_port_helpers import replay_params

H, W = 64, 96


def _inputs(b=6, m=4, seed=3):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 255, (b, H, W, 3), dtype=np.uint8)
    x1 = rng.uniform(0, W - 30, (b, m))
    y1 = rng.uniform(0, H - 30, (b, m))
    boxes = np.stack(
        [x1, y1, x1 + rng.uniform(4, 30, (b, m)),
         y1 + rng.uniform(4, 30, (b, m))], -1
    ).astype(np.float32)
    valid = rng.uniform(size=(b, m)) < 0.8
    return images, boxes, valid


@pytest.mark.parametrize(
    "cfg_kw, seed",
    [({}, 11), ({}, 12), (dict(p_rotate=1.0, p_hsv=1.0), 13),
     (dict(p_rotate=0.0, p_channel_shuffle=1.0), 14)],
)
def test_apply_augment_matches_jax(cfg_kw, seed):
    """Same parameters, both packages, ``warp_impl="twopass"``: boxes within
    1e-3 px with identical validity; uint8 images within 1 level (a pixel
    whose f32 value sits at an integer boundary may truncate either way),
    in fewer than 1e-3 of the pixels (measured: 0.8e-4 to 2.0e-4; boxes
    come out equal)."""
    images, boxes, valid = _inputs()
    key = jax.random.key(seed)
    jcfg, tcfg = jaug.AugmentConfig(**cfg_kw), taug.AugmentConfig(**cfg_kw)
    ref_img, ref_box, ref_valid = jaug.augment_batch(
        key, jnp.asarray(images), jnp.asarray(boxes), jnp.asarray(valid),
        jcfg, warp_impl="twopass",
    )
    params = replay_params(key, images.shape[0], jcfg, (H, W))
    img, box, ok = taug.apply_augment(
        torch.tensor(images), torch.tensor(boxes), torch.tensor(valid),
        params, tcfg, warp_impl="twopass",
    )
    assert img.dtype == torch.uint8
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref_valid))
    np.testing.assert_allclose(box.numpy(), np.asarray(ref_box), atol=1e-3)
    diff = np.abs(img.numpy().astype(np.int32) - np.asarray(ref_img, np.int32))
    assert diff.max() <= 1
    assert (diff != 0).mean() < 1e-3
    # "auto" on CPU tensors is the plain two-pass warp; "kernel" goes
    # through the wrapper, which runs the same plain version on the CPU.
    for impl in ("auto", "kernel"):
        again = taug.apply_augment(
            torch.tensor(images), torch.tensor(boxes), torch.tensor(valid),
            params, tcfg, warp_impl=impl,
        )
        assert torch.equal(again[0], img) and torch.equal(again[1], box)


def test_apply_augment_oneshot_matches_jax():
    images, boxes, valid = _inputs()
    key = jax.random.key(21)
    cfg_kw = dict(rotate_limit=(-80.0, 80.0), p_rotate=1.0)
    jcfg, tcfg = jaug.AugmentConfig(**cfg_kw), taug.AugmentConfig(**cfg_kw)
    ref_img, ref_box, _ = jaug.augment_batch(
        key, jnp.asarray(images), jnp.asarray(boxes), jnp.asarray(valid),
        jcfg, warp_impl="oneshot",
    )
    params = replay_params(key, images.shape[0], jcfg, (H, W))
    args = (torch.tensor(images), torch.tensor(boxes), torch.tensor(valid))
    img, box, _ = taug.apply_augment(*args, params, tcfg, warp_impl="oneshot")
    np.testing.assert_allclose(box.numpy(), np.asarray(ref_box), atol=1e-3)
    diff = np.abs(img.numpy().astype(np.int32) - np.asarray(ref_img, np.int32))
    assert diff.max() <= 1 and (diff != 0).mean() < 1e-3
    # Rotations beyond 45 degrees are refused by the two-pass backends.
    with pytest.raises(ValueError):
        taug.apply_augment(*args, params, tcfg, warp_impl="twopass")
    with pytest.raises(ValueError):
        taug.apply_augment(*args, params, taug.AugmentConfig(), "nearest")


def test_hsv_round_trip_matches_jax():
    rgb = np.random.default_rng(0).uniform(0, 255, (3, 16, 16, 3))
    rgb[0, 0, 0] = 0.0            # black: mx == 0
    rgb[0, 0, 1] = 77.0           # gray: d == 0
    rgb = rgb.astype(np.float32)
    ref = jaug._rgb_to_hsv(jnp.asarray(rgb))
    got = taug._rgb_to_hsv(torch.tensor(rgb))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-4)
    back = taug._hsv_to_rgb(*got).numpy()
    np.testing.assert_allclose(back, rgb, atol=1e-3)
    shifted = [got[0] + 170.0, got[1] - 40.0, got[2] + 30.0]
    ref_shift = jaug._hsv_to_rgb(*(jnp.asarray(t.numpy()) for t in shifted))
    np.testing.assert_allclose(
        taug._hsv_to_rgb(*shifted).numpy(), np.asarray(ref_shift),
        rtol=1e-5, atol=1e-3,
    )


def _within_4_sigma(count, n, p):
    return abs(count - n * p) <= 4 * math.sqrt(n * p * (1 - p))


def test_sampler_frequencies_and_ranges():
    """4000 draws against AugmentConfig: each coin within 4 binomial sigma,
    each magnitude inside its range and spread over it, translate-x and
    translate-y on ONE coin."""
    n = 4000
    cfg = taug.AugmentConfig(p_scale=0.3, p_translate=0.6, p_rotate=0.4,
                             p_flip=0.7, p_channel_shuffle=0.2, p_hsv=0.8)
    gen = torch.Generator().manual_seed(0)
    p = taug.sample_augment_params(gen, n, cfg, (H, W), "cpu")
    assert p.ms.shape == (n, 3, 3) and p.ms.dtype == torch.float32
    a, b, e = p.ms[:, 0, 0], p.ms[:, 0, 1], p.ms[:, 0, 2]
    c, d, f = p.ms[:, 1, 0], p.ms[:, 1, 1], p.ms[:, 1, 2]
    assert torch.equal(p.ms[:, 2], torch.tensor([0.0, 0.0, 1.0]).expand(n, 3))

    scale = torch.sqrt(a * a + c * c)
    scaled = (scale - 1).abs() > 1e-6
    assert _within_4_sigma(int(scaled.sum()), n, cfg.p_scale)
    assert 0.8 - 1e-5 <= float(scale.min()) and float(scale.max()) <= 1.2 + 1e-5
    assert float(scale.max()) > 1.15 and float(scale.min()) < 0.85

    det = a * d - b * c  # < 0 iff flipped
    flipped = det < 0
    assert _within_4_sigma(int(flipped.sum()), n, cfg.p_flip)
    # HFlip negates the first column, VFlip the second; rotation angle from
    # the un-flipped column.  OneOf: half of the flips are horizontal.
    theta_h = torch.atan2(-b, d)   # valid when the first column flipped
    theta_v = torch.atan2(c, a)    # valid when the second column flipped
    plain_theta = torch.atan2(c, a)
    hflip = flipped & (theta_h.abs() <= math.pi / 4 + 1e-4)
    assert _within_4_sigma(int(hflip.sum()), int(flipped.sum()), 0.5)
    theta = torch.where(flipped, torch.where(hflip, theta_h, theta_v), plain_theta)
    rotated = theta.abs() > 1e-6
    assert _within_4_sigma(int(rotated.sum()), n, cfg.p_rotate)
    assert float(theta.abs().max()) <= math.pi / 4 + 1e-4
    assert float(theta.max()) > 0.7 and float(theta.min()) < -0.7

    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    tx = e - (cx - a * cx - b * cy)
    ty = f - (cy - c * cx - d * cy)
    moved_x, moved_y = tx.abs() > 1e-3, ty.abs() > 1e-3
    assert _within_4_sigma(int(moved_x.sum()), n, cfg.p_translate)
    # The shared coin: x moves iff y moves (never one without the other,
    # up to a draw that lands within 1e-3 px of zero).
    assert int((moved_x ^ moved_y).sum()) <= 2
    assert float(tx.abs().max()) <= 0.2 * W + 1e-3
    assert float(ty.abs().max()) <= 0.2 * H + 1e-3
    assert float(tx.max()) > 0.18 * W and float(ty.min()) < -0.18 * H

    identity = torch.arange(3).expand(n, 3)
    assert torch.equal(p.perm.sort(-1).values, identity)
    shuffled = (p.perm != identity).any(-1)
    # A drawn permutation is the identity 1 time in 6.
    assert _within_4_sigma(int(shuffled.sum()), n, cfg.p_channel_shuffle * 5 / 6)
    assert _within_4_sigma(int(p.do_hsv.sum()), n, cfg.p_hsv)
    for t, lim in ((p.dh, 20.0), (p.ds, 30.0), (p.dv, 20.0)):
        assert float(t.abs().max()) <= lim
        assert float(t.max()) > 0.9 * lim and float(t.min()) < -0.9 * lim
        assert abs(float(t.mean())) < 4 * lim / math.sqrt(3 * n)


def test_sampler_is_deterministic_per_seed_and_augment_batch_runs():
    images, boxes, valid = _inputs()
    args = (torch.tensor(images), torch.tensor(boxes), torch.tensor(valid))
    outs = [
        taug.augment_batch(torch.Generator().manual_seed(5), *args)
        for _ in range(2)
    ]
    other = taug.augment_batch(torch.Generator().manual_seed(6), *args)
    for x, y in zip(outs[0], outs[1]):
        assert torch.equal(x, y)
    assert not torch.equal(outs[0][0], other[0])
    img, box, ok = outs[0]
    assert img.shape == args[0].shape and img.dtype == torch.uint8
    assert box.shape == args[1].shape and ok.dtype == torch.bool
    assert bool((ok <= args[2]).all())  # augmentation only invalidates


def test_identity_config_passes_through():
    cfg = taug.AugmentConfig(p_scale=0, p_translate=0, p_rotate=0, p_flip=0,
                             p_channel_shuffle=0, p_hsv=0)
    images, boxes, valid = _inputs()
    img, box, ok = taug.augment_batch(
        torch.Generator().manual_seed(0), torch.tensor(images),
        torch.tensor(boxes), torch.tensor(valid), cfg,
    )
    assert torch.equal(img, torch.tensor(images))
    np.testing.assert_allclose(box.numpy(), boxes, atol=1e-4)
    assert torch.equal(ok, torch.tensor(valid))


@pytest.mark.parametrize(
    "kw",
    [{}, dict(rotate_limit=(-10.0, 30.0)), dict(p_rotate=0.0),
     dict(scale_limit=(-0.5, 0.1)), dict(rotate_limit=(0.0, 45.0),
                                         scale_limit=(0.1, 0.2))],
)
def test_warp_max_shear_matches_jax(kw):
    assert taug.warp_max_shear(taug.AugmentConfig(**kw)) == pytest.approx(
        jaug.warp_max_shear(jaug.AugmentConfig(**kw)), rel=1e-12
    )


def test_warp_max_shear_errors():
    with pytest.raises(ValueError, match="45 deg"):
        taug.warp_max_shear(taug.AugmentConfig(rotate_limit=(-46.0, 10.0)))
    with pytest.raises(ValueError, match="scale_limit"):
        taug.warp_max_shear(taug.AugmentConfig(scale_limit=(-1.0, 0.2)))
