"""The port's int8 PTQ engine (``odc_tpu_torch/ops/int8_engine.py``) against
``odc_tpu.ops.int8_engine`` on the CPU: calibration ranges, the int8 codes
after several layers, the head in each stem mode, the port's own s2d
identities, ``make_infer_fn(int8_scales=...)`` end to end, and the
rejections.  Full-width YOLOv2 with BN calibrated on the images, 2 x 64 x 96.

The JAX engine runs eagerly, op by op, as ``tests/test_int8_engine.py``
runs it.  Fed the same weights, images and scales, the two engines agree
bit for bit here: both compute every epilogue op on its own (no fused
multiply-add), the int32 accumulators are exact, and the float convs (the
s2d stem, the bf16 head) round alike on this CPU.  A jitted JAX engine is
another matter: XLA fuses the epilogues, and on this network, whose
calibrated random weights amplify any difference from layer to layer, one
flipped code early on grows into many (``ROADMAP.md`` Queue 3)."""

import contextlib
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from odc_tpu.ops import int8_engine as je
from odc_tpu.ops.detect import jit_infer_fn
from odc_tpu_torch.models.yolov2 import YOLOv2
from odc_tpu_torch.ops import int8_engine as te
from odc_tpu_torch.ops.cuda import matmul_kernel
from odc_tpu_torch.ops.cuda.matmul_kernel import matmul, route
from odc_tpu_torch.ops.cuda.nms_kernel import suppress
from odc_tpu_torch.ops.detect import make_infer_fn
from torch_port_helpers import int8_parity_setup, port_model


@contextlib.contextmanager
def _recording(module, codes: list):
    """Record every output of ``module._quant_act``: the int8 codes of each
    layer the engine quantizes (the s2d stem's before its phase-max), in
    order.  Both engines call it once per backbone conv."""
    real = module._quant_act

    def record(y, s, z):
        q = real(y, s, z)
        codes.append(np.asarray(q))
        return q

    module._quant_act = record
    try:
        yield codes
    finally:
        module._quant_act = real


# The engine configurations compared with JAX: the shipped s2d stem, the
# all-int8 plain stem, and conv0 in bf16 (stem='s2d2' is held to s2d).
_MODES = {"s2d": dict(stem="s2d"), "plain": dict(stem="plain"),
          "bf16_front": dict(stem="plain", bf16_front=1)}


@pytest.fixture(scope="module")
def engine():
    """Images, both models, the JAX package's calibrated scales, and for
    each stem the eager JAX engine's head, per-layer codes and neck input.
    The first eager run compiles every op of the network once (30-45 s
    here); the second stem and the ``stop_after`` prefix reuse them."""
    images, jmodel, variables = int8_parity_setup()
    jv = jax.tree.map(jnp.asarray, variables)
    scales = np.array(je.calibrate(jv, jnp.asarray(images)))
    ref = {}
    for name, kw in _MODES.items():
        run = functools.partial(
            je.yolov2_int8_forward, jv, jnp.asarray(images),
            scales=jnp.asarray(scales), **kw)
        with _recording(je, []) as codes:
            head = np.asarray(run())
        ref[name] = dict(head=head, codes=codes)
        if name != "bf16_front":
            ref[name]["neck_in"] = np.asarray(run(stop_after=21))
    model = port_model(variables)
    port = {}
    for name in ("s2d", "plain"):
        run = functools.partial(
            te.yolov2_int8_forward, model, torch.tensor(images),
            scales=scales, **_MODES[name])
        with _recording(te, []) as codes:
            run()
        port[name] = dict(codes=codes, neck_in=run(stop_after=21).numpy())
    return dict(images=images, jmodel=jmodel, jv=jv, model=model,
                scales=scales, ref=ref, port=port)


def _port_forward(engine, **kw):
    return te.yolov2_int8_forward(
        engine["model"], torch.tensor(engine["images"]),
        scales=engine["scales"], **kw).numpy()


def _bf16_ulp(x) -> float:
    """One bf16 ulp at the largest magnitude of ``x``."""
    return 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


@pytest.mark.parametrize("percentile", [None, 99.9])
def test_calibrate_matches_jax(engine, percentile):
    """The [22, 2] (pos, neg) ranges within rtol 1e-4 of JAX's: f32 convs
    summed in another order, through 22 layers of a network that amplifies
    such differences (measured 2.8e-5 relative at worst, ROADMAP Queue
    3)."""
    images = engine["images"]
    ref = (engine["scales"] if percentile is None else np.asarray(
        je.calibrate(engine["jv"], jnp.asarray(images), percentile)))
    got = te.calibrate(engine["model"], torch.tensor(images), percentile)
    assert got.shape == (22, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4)
    assert (got.numpy() >= 1e-6).all()
    if percentile is not None:  # clipping lowered every positive range
        assert (got.numpy()[:, 0] < engine["scales"][:, 0]).all()


def test_calibration_pass_is_the_f32_model(engine):
    """The engine's calibration pass (scales=None) computes the port's own
    f32 forward, which defines what the int8 path approximates: within
    rtol 1e-4 (the BN and bias ops run in another order; measured 2e-5 of
    the head's range after 22 layers)."""
    model = engine["model"]
    x = torch.tensor(engine["images"])
    y, _ = te.yolov2_int8_forward(model, x, scales=None)
    with torch.no_grad():
        ref = model(x).numpy()
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("stem", ["s2d", "plain"])
@pytest.mark.parametrize("layer", list(range(20)) + ["neck_in"])
def test_codes_match_jax(engine, stem, layer):
    """The int8 codes of every quantized layer (the 20 backbone convs, the
    s2d stem's before its phase-max) and the requantized neck input:
    bitwise equal to the eager JAX engine's, no one-level flips."""
    ref, got = engine["ref"][stem], engine["port"][stem]
    if layer == "neck_in":
        got, want = got["neck_in"], ref["neck_in"]
    else:
        got, want = got["codes"][layer], ref["codes"][layer]
    assert got.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("stem", ["s2d", "plain"])
def test_stop_after_returns_the_layer_codes(engine, stem):
    """``stop_after=i`` returns conv i's codes (the s2d stem's phase-maxed)."""
    codes = engine["port"][stem]["codes"]
    for i in (0, 1, 4, 12, 19):
        want = codes[i]
        if i == 0 and stem == "s2d":
            want = te._phase_max(torch.tensor(want)).numpy()
        np.testing.assert_array_equal(
            _port_forward(engine, stem=stem, stop_after=i), want)


@pytest.mark.parametrize("mode", list(_MODES))
def test_head_matches_jax(engine, mode):
    """The raw head [2, 2, 3, 5, 25] f32 within one bf16 ulp of its range
    (the bf16 head conv rounds its output; measured equal), for the s2d and
    plain stems and with conv0 in bf16.  stem='s2d2' gives the s2d codes
    bit for bit in both packages (:func:`test_s2d_identities` here,
    ``tests/test_int8_engine.py`` there), so its head is held to JAX's
    through the s2d one."""
    ref = engine["ref"][mode]["head"]
    got = _port_forward(engine, **_MODES[mode])
    assert got.shape == ref.shape == (2, 2, 3, 5, 25)
    np.testing.assert_allclose(got, ref, rtol=0, atol=_bf16_ulp(ref))


def test_jitted_jax_engine_differs_at_the_first_layer(engine):
    """Why the comparisons above run the JAX engine eagerly: compiled
    whole, XLA fuses the s2d stem's epilogue and rounds about one code in
    1e5 to its neighbour (measured 1.0e-5 here), and this network carries
    such a flip into more and more codes layer after layer (ROADMAP Queue
    3).  The eager engine and the port agree on every code."""
    images, scales = engine["images"], engine["scales"]
    jitted = np.asarray(jax.jit(
        lambda v, x, s: je.yolov2_int8_forward(
            v, x, scales=s, stem="s2d", stop_after=0))(
        engine["jv"], jnp.asarray(images), jnp.asarray(scales)))
    eager = te._phase_max(torch.tensor(engine["ref"]["s2d"]["codes"][0]))
    diff = np.abs(jitted.astype(np.int32) - eager.numpy())
    assert diff.max() <= 1 and (diff != 0).mean() < 1e-4
    np.testing.assert_array_equal(
        _port_forward(engine, stem="s2d", stop_after=0), eager.numpy())


def test_s2d_identities(engine):
    """stem='s2d2' (conv1 + pool lifted, int8) is an exact reformulation of
    stem='s2d': the stage-2 codes equal the pooled s2d codes and the heads
    are equal, as the int8 sums are exact.  stem='s2d' and bf16_front=1
    compute conv0 as two different f32 convolutions of the same bf16
    values (4x4 stride 2 and 3x3), whose sums PyTorch may order
    differently: their codes after conv1 are at most one level apart in
    at most 1e-3 of the codes (measured equal here; one model at 64 x 96
    differed in 20 of 196,608)."""
    s2d = te._pool(torch.tensor(_port_forward(engine, stem="s2d", stop_after=1)))
    s2d2 = _port_forward(engine, stem="s2d2", stop_after=1)
    np.testing.assert_array_equal(s2d2, s2d.numpy())
    np.testing.assert_array_equal(_port_forward(engine, stem="s2d2"),
                                  _port_forward(engine, stem="s2d"))
    diff = np.abs(
        _port_forward(engine, stem="s2d", stop_after=1).astype(np.int32)
        - _port_forward(engine, bf16_front=1, stop_after=1))
    assert diff.max() <= 1 and (diff != 0).mean() <= 1e-3


def test_infer_int8_scales_matches_jax(engine, monkeypatch):
    """``make_infer_fn(int8_scales=..., int8_stem='s2d')`` against the JAX
    package's ``jit_infer_fn``, whose engine is swapped for the eager
    engine's head (compiled whole, the engine itself would differ, see
    above): kept set and order identical at a conf in the largest gap of
    the candidates; boxes, confs and class scores within 1e-4 (the decode's
    transcendental functions differ by a few ulps, ROADMAP Queue 3);
    ``compact`` output derived alike.  On the CPU the GEMM runs its plain
    version: no launches."""
    images, scales = engine["images"], engine["scales"]
    head = engine["ref"]["s2d"]["head"]
    monkeypatch.setattr(je, "yolov2_int8_forward",
                        lambda *a, **kw: jnp.asarray(head))
    s = np.sort(1.0 / (1.0 + np.exp(-head[..., 4].astype(np.float64).ravel())))
    s = s[::-1][:40]
    r = int(np.argmax(s[:-1] - s[1:]))
    assert s[r] - s[r + 1] > 1e-3
    thre = float((s[r] + s[r + 1]) / 2)
    jinfer = jit_infer_fn(engine["jmodel"], max_keep=64,
                          int8_scales=jnp.asarray(scales))
    ref = [np.asarray(a) for a in jinfer(engine["jv"], images, thre, 0.5)]
    monkeypatch.undo()
    before = (matmul.launches, suppress.launches)
    outs = []
    for compact in (False, True):
        infer = make_infer_fn(engine["model"], conf_thre=thre, max_keep=64,
                              compact=compact, int8_scales=scales)
        outs.append([t.numpy() for t in infer(torch.tensor(images))])
    assert (matmul.launches, suppress.launches) == before
    got, compact = outs
    assert 0 < ref[-1].sum() < ref[-1].size
    np.testing.assert_array_equal(got[-1], ref[-1])
    for g, r in zip(got[:-1], ref[:-1]):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(compact[2], got[2].argmax(-1))
    np.testing.assert_array_equal(compact[3], got[2].max(-1))
    for c, g in zip(compact[:2] + compact[4:], got[:2] + got[3:]):
        np.testing.assert_array_equal(c, g)


def test_rejections(engine):
    """valid_hw with the s2d2 stem or a bf16 front, a space_to_depth model,
    a wrong scale matrix and an unknown stem are refused as in JAX."""
    model, x = engine["model"], torch.tensor(engine["images"])
    for kw in (dict(stem="s2d2"), dict(stem="plain", bf16_front=1)):
        with pytest.raises(ValueError, match="valid_hw supports"):
            te.yolov2_int8_forward(model, x, scales=engine["scales"],
                                   valid_hw=torch.tensor([[64, 96], [64, 96]]),
                                   **kw)
    with pytest.raises(ValueError, match="shape"):
        te.yolov2_int8_forward(model, x, scales=engine["scales"][:21])
    with pytest.raises(ValueError, match="stem"):
        te.yolov2_int8_forward(model, x, scales=engine["scales"], stem="s4d")
    s2d_model = YOLOv2(neck="space_to_depth", device="cpu")
    for kw in (dict(int8_scales=engine["scales"]), dict(int8_neck=True)):
        with pytest.raises(ValueError, match="neck='quadrant'"):
            make_infer_fn(s2d_model, **kw)


@pytest.mark.parametrize("stem, gemms", [("s2d", 20), ("s2d2", 20),
                                         ("plain", 21)])
def test_every_engine_gemm_takes_the_wgmma_route(engine, stem, gemms,
                                                 monkeypatch):
    """Every GEMM the engine hands the kernel wrapper, as the wrapper
    receives it, is one that :func:`route` sends to the wgmma + TMA kernel
    on the card: int8, K padded to a multiple of 32, aligned bases.  K and
    N do not depend on the image size, so the 416x416 path's GEMMs have
    these shapes with larger M."""
    seen = []

    def record(a, b):
        seen.append((a.shape[0], a.shape[1], b.shape[1],
                     route(a.shape[0], b.shape[1], a.shape[1], a.dtype, a, b)))
        return matmul(a, b)

    monkeypatch.setattr(matmul_kernel, "matmul", record)
    _port_forward(engine, stem=stem)
    assert len(seen) == gemms
    assert [r for *_, r in seen] == ["wgmma"] * gemms, seen
    assert all(k % 32 == 0 for _, k, _, _ in seen)
