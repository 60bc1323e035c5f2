"""The port's native-size forward (``valid_hw``) against the JAX package's
on the CPU: ``extent_mask``, ``quadrant_stack_dynamic``, the masked f32
YOLOv2 forward (against the port's own native-size runs and against JAX's
masked forward), the int8 engine's masked bucket against its own
native-size runs, and ``make_native_infer_fn``.  Full-width YOLOv2 with
bridged JAX weights and BN calibrated on the bucket's images, at a
96 x 128 bucket.

Tolerances: the forward within the port's f32 forward tolerance (rtol 1e-3,
atol 2e-3: convolutions summed in another order).  The NMS threshold is
placed in the largest gap between candidate confidences (as
``chip_smoke.py::_gap_threshold`` does), so ulp-level differences between
the frameworks cannot change which candidates survive; keep masks and
labels are then equal.  Boxes are held within 1e-4 of the largest
coordinate: the heads differ by up to 3e-5 of their range (measured
6.9e-5 on a range of 2.6), which ``exp`` carries into the box sizes
(measured 0.011 px on 302 px).  Confidences and scores within 2e-5
(measured 3.5e-6)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from odc_tpu.models import layers as jlayers
from odc_tpu.models import yolov2 as jyolov2
from odc_tpu.ops.detect import make_native_infer_fn as j_native_infer_fn
from odc_tpu_torch.eval import Detector
from odc_tpu_torch.models import layers as tlayers
from odc_tpu_torch.models.yolov2 import YOLOv2, quadrant_stack_dynamic
from odc_tpu_torch.ops import int8_engine as te
from odc_tpu_torch.ops.detect import make_native_infer_fn
from torch_port_helpers import (
    calibrated_yolov2, gap_threshold, pad_to_bucket, port_model,
)

BUCKET = (96, 128)
# A bucket-filling image (runs the eh == H / ew == W edges) and an odd one.
SIZES = [(96, 128), (70, 101)]


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    natives = [rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
               for h, w in SIZES]
    imgs, vhw = pad_to_bucket(natives, BUCKET)
    jmodel, variables = calibrated_yolov2(imgs)
    return dict(natives=natives, imgs=imgs, vhw=vhw, jmodel=jmodel,
                jv=jax.tree.map(jnp.asarray, variables),
                model=port_model(variables))


@pytest.mark.parametrize("shape, eh, ew", [
    ((3, 5, 7, 2), [5, 3, 1], [7, 4, 0]),
    ((2, 12, 16, 1), [12, 9], [16, 16]),
    ((1, 4, 4, 3), [2], [3]),
])
def test_extent_mask_matches_jax(shape, eh, ew):
    ref = np.asarray(jlayers.extent_mask(
        shape, jnp.asarray(eh, jnp.int32), jnp.asarray(ew, jnp.int32)))
    got = tlayers.extent_mask(shape, torch.tensor(eh), torch.tensor(ew))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("hh, ww, seed", [(6, 8, 0), (7, 5, 1), (4, 4, 2)])
def test_quadrant_stack_dynamic_matches_jax(hh, ww, seed):
    """Random maps and random c5 extents, including bucket-filling ones,
    the 64x64 pad slot's (4) and extents beyond the map, where both clamp
    the start to [0, H - H//2]."""
    rng = np.random.default_rng(seed)
    b = 6
    x = rng.standard_normal((b, hh, ww, 3)).astype(np.float32)
    e16h = np.concatenate([[hh, 4, 2 * hh + 1], rng.integers(1, hh + 1, b - 3)])
    e16w = np.concatenate([[ww, 4, 0], rng.integers(1, ww + 1, b - 3)])
    ref = np.asarray(jyolov2.quadrant_stack_dynamic(
        jnp.asarray(x), jnp.asarray(e16h, jnp.int32),
        jnp.asarray(e16w, jnp.int32)))
    got = quadrant_stack_dynamic(torch.tensor(x), torch.tensor(e16h),
                                 torch.tensor(e16w))
    np.testing.assert_array_equal(got.numpy(), ref)
    # The int8 engine passes codes.
    q = torch.tensor(x * 30).to(torch.int8)
    np.testing.assert_array_equal(
        quadrant_stack_dynamic(q, torch.tensor(e16h), torch.tensor(e16w)),
        np.asarray(jyolov2.quadrant_stack_dynamic(
            jnp.asarray(q.numpy()), jnp.asarray(e16h, jnp.int32),
            jnp.asarray(e16w, jnp.int32))))


def test_masked_forward_equals_native(setup):
    """Each image's valid grid cells of the padded, masked forward equal
    its native-size run (summation order apart)."""
    model = setup["model"]
    with torch.no_grad():
        y_pad = model(torch.tensor(setup["imgs"]), valid_hw=setup["vhw"])
        for j, img in enumerate(setup["natives"]):
            y_nat = model(torch.tensor(img[None]))
            gh, gw = img.shape[0] // 32, img.shape[1] // 32
            assert y_nat.shape[1:3] == (gh, gw)
            np.testing.assert_allclose(y_pad[j, :gh, :gw], y_nat[0],
                                       rtol=1e-4, atol=1e-4)


def test_int8_masked_bucket_equals_native_runs(setup):
    """The int8 engine, mirroring ``tests/test_int8_engine.py``: with the
    plain stem (all-int8 up to the neck, exact int32 sums) each image's
    valid neck-input codes equal its native-size run bit for bit; the
    head, for both shipped stems, lies within the JAX test's budget (5% of
    the head's largest value: the s2d stem is a float conv, whose codes may
    flip by one level across shapes)."""
    model, imgs, vhw = setup["model"], setup["imgs"], setup["vhw"]
    scales = te.calibrate(model, torch.tensor(imgs))

    def run(x, **kw):
        return te.yolov2_int8_forward(model, torch.tensor(x), scales=scales,
                                      **kw)

    masked = run(imgs, stem="plain", valid_hw=vhw, stop_after=21)
    heads = {stem: run(imgs, stem=stem, valid_hw=vhw)
             for stem in ("plain", "s2d")}
    for j, img in enumerate(setup["natives"]):
        gh, gw = img.shape[0] // 32, img.shape[1] // 32
        np.testing.assert_array_equal(
            masked[j, :gh, :gw], run(img[None], stem="plain",
                                     stop_after=21)[0], err_msg=f"image {j}")
        for stem, head in heads.items():
            y = run(img[None], stem=stem)[0]
            diff = float((head[j, :gh, :gw] - y).abs().max())
            assert diff < 0.05 * max(float(y.abs().max()), 1e-3), (stem, j)


def test_masked_forward_space_to_depth_neck():
    """The same claim for the paper-style space_to_depth neck (block-local,
    so the static reorg is exact under padding)."""
    model = YOLOv2(neck="space_to_depth", device="cpu", seed=1).eval()
    rng = np.random.default_rng(8)
    img = rng.integers(0, 255, (65, 130, 3), dtype=np.uint8)
    padded = np.zeros((1, 96, 160, 3), np.uint8)
    padded[0, :65, :130] = img
    with torch.no_grad():
        y_nat = model(torch.tensor(img[None]))
        y_pad = model(torch.tensor(padded), valid_hw=[[65, 130]])
    gh, gw = y_nat.shape[1:3]
    np.testing.assert_allclose(y_pad[:, :gh, :gw], y_nat, rtol=1e-4,
                               atol=1e-4 * float(y_nat.abs().max()))


def test_masked_forward_matches_jax(setup):
    """The port's masked forward against JAX's on the same bucket, over
    every cell (junk cells included: both compute the same function)."""
    ref = np.asarray(jax.jit(
        lambda v, x, h: setup["jmodel"].apply(v, x, train=False, valid_hw=h)
    )(setup["jv"], setup["imgs"], setup["vhw"]))
    with torch.no_grad():
        got = setup["model"](torch.tensor(setup["imgs"]),
                             valid_hw=setup["vhw"]).numpy()
    assert got.shape == ref.shape == (2, 3, 4, 5, 25)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=2e-3)


def test_masked_forward_refusals(setup):
    model, x = setup["model"], torch.tensor(setup["imgs"])
    with pytest.raises(ValueError, match="mutually exclusive"):
        model.backbone(x, stem_out=torch.zeros(2, 24, 32, 64),
                       valid_hw=torch.tensor(setup["vhw"]))
    with pytest.raises(ValueError, match="inference-only"):
        model(x, valid_hw=setup["vhw"], neck_override=lambda h: h)
    model.train()
    try:
        with pytest.raises(ValueError, match="inference-only"):
            model(x, valid_hw=setup["vhw"])
    finally:
        model.eval()


def test_native_infer_matches_jax(setup):
    """``make_native_infer_fn`` against JAX's on one padded bucket of two
    images, at a threshold in a gap of the candidates' confidences."""
    model = setup["model"]
    with torch.no_grad():
        y = model(torch.tensor(setup["imgs"]), valid_hw=setup["vhw"])
    conf = torch.sigmoid(y[..., 4]).numpy()
    # Only cells inside each image's grid are candidates.
    valid = [conf[j, : h // 32, : w // 32] for j, (h, w) in enumerate(SIZES)]
    n = sum(v.size for v in valid)
    thre = gap_threshold(np.concatenate([v.ravel() for v in valid]),
                          n // 8, n // 2)
    ref = [np.asarray(o) for o in jax.jit(
        j_native_infer_fn(setup["jmodel"], thre, 0.5, 16)
    )(setup["jv"], setup["imgs"], setup["vhw"])]
    got = [o.numpy() for o in make_native_infer_fn(model, thre, 0.5, 16)(
        setup["imgs"], setup["vhw"])]
    keep = ref[4]
    assert keep.any(1).all() and not keep.all()
    np.testing.assert_array_equal(got[4], keep)
    np.testing.assert_array_equal(got[2][keep], ref[2][keep])
    np.testing.assert_allclose(got[0], ref[0], rtol=0,
                               atol=1e-4 * np.abs(ref[0]).max())
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got[3], ref[3], rtol=0, atol=2e-5)


def test_native_infer_boxes_match_detect(setup):
    """Bucketed masked inference == the port's per-image native
    ``Detector.detect`` for each image: the same kept boxes in native
    pixels, the same labels and scores."""
    model = setup["model"]
    det = Detector(model, conf_thre=0.3, max_keep=16)
    boxes_b, _conf, lbl_b, score_b, keep_b = (
        o.numpy() for o in make_native_infer_fn(model, 0.3, 0.5, 16)(
            setup["imgs"], setup["vhw"]))
    for j, img in enumerate(setup["natives"]):
        ref = det.detect(img)
        keep = keep_b[j]
        ref_boxes = np.asarray(ref["bbox_list"], np.float64).reshape(-1, 4)
        assert len(ref_boxes) == keep.sum() > 0
        np.testing.assert_allclose(boxes_b[j][keep], ref_boxes, rtol=1e-3,
                                   atol=5e-3)
        assert [det.cls_list[k] for k in lbl_b[j][keep]] == ref["lbl_list"]
        np.testing.assert_allclose(
            score_b[j][keep], ref["cls_spec_conf_score_list"], rtol=1e-3,
            atol=1e-4)
