"""The port's YOLOv3 (``odc_tpu_torch.models.yolov3``, Darknet-53,
``decode_v3``, ``int8_dynamic``, ``make_infer_fn``, the weight bridge)
against the JAX package on the CPU, f32, full width (YOLOv3-416's widths:
Darknet-53, the three-scale FPN, 9 anchors, 20 classes) at 64x64, and
Darknet-53 with VALID downsamples at 96x96.

No flax init is compiled: the port's own seeded init, with BN calibrated
on eight images, is carried into JAX through the bridge (whose tree is
checked against ``YOLOv3.init``'s by ``jax.eval_shape``).  The JAX
forwards held at the f32 tolerance are jitted (a third of the eager time
here); the int8 forward and ``make_infer_fn`` run eagerly, op by op, as
a jitted JAX int8 model fuses its epilogues and flips codes.  Eight images, as for YOLOv1: the last
blocks see 2 x 2 positions an image at 64x64, and two images leave
near-zero BN variances that amplify summation-order noise."""

import copy
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from odc_tpu.models.backbones.darknet53 import (
    Darknet53Backbone as JaxDarknet53,
)
from odc_tpu.models.layers import ConvBnLeaky as JaxConvBnLeaky
from odc_tpu.models.yolov3 import YOLOv3 as JaxYOLOv3
from odc_tpu.ops import decode as jdecode
from odc_tpu.ops import detect as jdetect
from odc_tpu.ops import quantize as jquant
from odc_tpu_torch.config import MODEL_CONFIG
from odc_tpu_torch.models import MODEL_REGISTRY, get_model, model_from_config
from odc_tpu_torch.models.backbones.darknet53 import Darknet53Backbone
from odc_tpu_torch.models.convert_jax import (
    jax_from_state_dict, load_jax_yolov3, state_dict_from_jax,
)
from odc_tpu_torch.models.layers import ConvBnLeaky, same_padding
from odc_tpu_torch.models import yolov3
from odc_tpu_torch.models.yolov3 import YOLOv3
from odc_tpu_torch.ops import decode as tdecode
from odc_tpu_torch.ops import detect as tdetect
from odc_tpu_torch.ops import quantize as tquant
from odc_tpu_torch.ops.cuda.matmul_kernel import matmul
from odc_tpu_torch.ops.cuda.nms_kernel import suppress
from torch_port_helpers import calibrate_bn, gap_threshold

# The forward tolerance of test_torch_yolov2 / tests/test_e2e_parity.py.
RTOL, ATOL = 1e-3, 2e-3
CALIB_IMAGES = 8
HW = (64, 64)
# Every 3x3 conv with >= 128 input channels: backbone 9 + 9 + 5, five-conv
# blocks 6, head 3x3s 3.
INT8_LAYERS = 32


def _images(hw, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, (CALIB_IMAGES, *hw, 3), dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def v3_setup(hw=HW, fused=True):
    """(images, JAX YOLOv3, numpy variables, the port's f32 CPU model in
    eval mode): the port's seeded init, BN calibrated on the images."""
    images = _images(hw)
    model = YOLOv3(image_size=hw, fused_lateral=fused, device="cpu").eval()
    variables = calibrate_bn(model, images)
    return images, JaxYOLOv3(image_size=hw, fused_lateral=fused), variables, \
        model


@functools.lru_cache(maxsize=None)
def _jax_forward(hw=HW, fused=True):
    """The JAX heads and Darknet-53 taps of :func:`v3_setup`'s images."""
    images, jmodel, variables, _ = v3_setup(hw, fused)

    def apply(v, x):
        return jmodel.apply(v, x, capture_intermediates=lambda mdl, _: (
            isinstance(mdl, JaxDarknet53)))

    ys, inter = jax.jit(apply)(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(images))
    taps = inter["intermediates"]["Darknet53Backbone_0"]["__call__"][0]
    return [np.asarray(y) for y in ys], [np.asarray(t) for t in taps]


@pytest.fixture(scope="module")
def shared():
    images, jmodel, variables, model = v3_setup()
    ys, taps = _jax_forward()
    return dict(images=images, jmodel=jmodel, variables=variables,
                jv=jax.tree.map(jnp.asarray, variables), model=model, ys=ys,
                taps=taps)


# -- layers ----------------------------------------------------------------


@pytest.mark.parametrize("n, padding", [(8, "SAME"), (9, "SAME"),
                                        (9, "VALID")])
def test_stride2_conv_bn_leaky_matches_jax(n, padding):
    """A 3x3 stride-2 ``ConvBnLeaky`` against flax's at an even and an odd
    size: XLA's SAME pads ``(0, 1)`` on an even size and ``(1, 1)`` on an
    odd one (``same_padding``), VALID none; within 1e-5 (summation
    order), random weights and BN statistics."""
    rng = np.random.default_rng(n)
    x = rng.normal(0, 1, (2, n, n, 16)).astype(np.float32)
    jblock = JaxConvBnLeaky(32, (3, 3), strides=(2, 2), padding=padding)

    def draw(*shape, scale=0.2, low=None):
        if low is not None:
            return rng.uniform(low, low + 1, shape).astype(np.float32)
        return rng.normal(0, scale, shape).astype(np.float32)

    v = {"params": {"Conv_0": {"kernel": draw(3, 3, 16, 32),
                               "bias": draw(32)},
                    "BatchNorm_0": {"scale": draw(32, low=0.5),
                                    "bias": draw(32)}},
         "batch_stats": {"BatchNorm_0": {"mean": draw(32),
                                         "var": draw(32, low=0.5)}}}
    ref = np.asarray(jblock.apply(v, jnp.asarray(x)))
    block = ConvBnLeaky(16, 32, 3, stride=2, padding=padding).eval()
    sd = {"conv.weight": v["params"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1),
          "conv.bias": v["params"]["Conv_0"]["bias"],
          "bn.weight": v["params"]["BatchNorm_0"]["scale"],
          "bn.bias": v["params"]["BatchNorm_0"]["bias"],
          "bn.running_mean": v["batch_stats"]["BatchNorm_0"]["mean"],
          "bn.running_var": v["batch_stats"]["BatchNorm_0"]["var"]}
    block.load_state_dict({k: torch.tensor(a) for k, a in sd.items()})
    with torch.no_grad():
        got = block(torch.tensor(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert same_padding(8, 3, 2) == (0, 1) and same_padding(9, 3, 2) == (1, 1)
    assert same_padding(7, 3, 1) == (1, 1)


def test_stride1_path_is_unchanged():
    """Stride 1 SAME keeps the symmetric padding inside the conv (the path
    of every earlier model, bitwise as before)."""
    block = ConvBnLeaky(8, 8, 3)
    assert block.conv.padding == (1, 1) and block.conv.stride == (1, 1)
    down = ConvBnLeaky(8, 8, 3, stride=2)
    assert down.conv.padding == (0, 0)
    with pytest.raises(ValueError, match="SAME"):
        ConvBnLeaky(8, 8, 3, padding="FULL")


# -- the model ---------------------------------------------------------------


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_darknet53_matches_jax(shared, padding):
    """Darknet-53 c3/c4/c5 against the JAX backbone, rtol 1e-3 and atol
    2e-3: SAME (YOLOv3's, 64x64 -> 8/4/2) from inside the JAX model's
    forward; VALID (the parity default, 96 -> 47 -> 23 -> 11 -> 5 -> 2)
    from the JAX backbone alone with the same weights, on other images."""
    if padding == "SAME":
        images = shared["images"]
        backbone, ref = shared["model"].backbone, shared["taps"]
    else:
        images = _images((96, 96), seed=1)
        backbone = Darknet53Backbone().eval()
        backbone.load_state_dict({
            k[len("backbone."):]: v for k, v in
            shared["model"].state_dict().items() if k.startswith("backbone.")})
        sub = {c: shared["variables"][c]["Darknet53Backbone_0"]
               for c in ("params", "batch_stats")}
        ref = [np.asarray(t) for t in jax.jit(JaxDarknet53().apply)(
            jax.tree.map(jnp.asarray, sub), jnp.asarray(images))]
    with torch.no_grad():
        got = [t.numpy() for t in backbone(torch.tensor(images))]
    sizes = (8, 4, 2) if padding == "SAME" else (11, 5, 2)
    for g, r, s, c in zip(got, ref, sizes, (256, 512, 1024)):
        assert g.shape == r.shape == (CALIB_IMAGES, s, s, c)
        assert r.std() > 0.1
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL)


def test_heads_match_jax_fused(shared):
    """The three heads [8, s, s, 3, 25] (s = 2, 4, 8) of the fused model
    from the same weights, rtol 1e-3 and atol 2e-3 (measured 7e-5)."""
    with torch.no_grad():
        got = [y.numpy() for y in shared["model"](
            torch.tensor(shared["images"]))]
    for g, r, s in zip(got, shared["ys"], (2, 4, 8)):
        assert g.shape == r.shape == (CALIB_IMAGES, s, s, 3, 25)
        assert g.dtype == np.float32 and r.std() > 0.1
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL)


@functools.lru_cache(maxsize=None)
def _jax_probes():
    """JAX ``YOLOv3.apply(..., stop_after=p)`` of the first two images for
    every probe ``p``, in one jitted program (9 s here, against about 15
    for eleven programs and 13 eagerly)."""
    images, jmodel, variables, _ = v3_setup()

    def probes(v, x):
        return {p: jmodel.apply(v, x, stop_after=p) for p in yolov3.PROBES}

    out = jax.jit(probes)(jax.tree.map(jnp.asarray, variables),
                          jnp.asarray(images[:2]))
    return jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("probe", yolov3.PROBES)
def test_stop_after_matches_jax(shared, probe):
    """Each prefix probe of the port against the JAX package's, from the
    same weights: the same structure (a map, the first head, or the
    cumulative tuples past it) within rtol 1e-3 and atol 2e-3."""
    with torch.no_grad():
        got = shared["model"](torch.tensor(shared["images"][:2]),
                              stop_after=probe)
    want = _jax_probes()[probe]
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
    else:
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and w.std() > 0.05
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL)


def test_stop_after_contract(shared):
    """The tuple shapes of the cumulative probes; the full forward's heads
    are the probes' heads; an unknown name and training mode raise."""
    model, x = shared["model"], torch.tensor(shared["images"][:2])
    with torch.no_grad():
        full = model(x)
        y32, y16, p3 = model(x, stop_after="p3")
        assert torch.equal(model(x, stop_after="y32"), full[0])
        assert torch.equal(y32, full[0]) and torch.equal(y16, full[1])
        assert tuple(p3.shape) == (2, 8, 8, 128)
        assert tuple(model(x, stop_after="b5").shape) == (2, 2, 2, 1024)
        with pytest.raises(ValueError, match="stop_after must be one of"):
            model(x, stop_after="b6")
    model.train()
    try:
        with pytest.raises(ValueError, match="inference-only"):
            model(x, stop_after="stem")
    finally:
        model.eval()


def test_heads_match_jax_concat():
    """The paper's concat formulation (``fused_lateral=False``), its own
    init with BN calibrated on the same images, rtol 1e-3 and atol
    2e-3."""
    images, _, _, model = v3_setup(HW, False)
    ys, _ = _jax_forward(HW, False)
    with torch.no_grad():
        got = [y.numpy() for y in model(torch.tensor(images))]
    for g, r, s in zip(got, ys, (2, 4, 8)):
        assert g.shape == r.shape == (CALIB_IMAGES, s, s, 3, 25)
        assert r.std() > 0.1
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL)


def _concat_to_fused(concat_sd):
    """The fused model's ``state_dict`` computing what the concat model's
    does: each merge's first 1x1 kernel split row-wise into ``conv_r``
    (the upsampled reduction's channels) and ``conv_c`` (the tap's), its
    BN moved to the merge, the block's other four layers shifted down."""
    sd = {k: v for k, v in concat_sd.items()
          if not k.startswith(("five16.", "five8."))}
    for s, nr in (("16", 256), ("8", 128)):
        first = f"five{s}.layers.0."
        w = concat_sd[first + "conv.weight"]
        sd[f"merge{s}.conv_r.weight"] = w[:, :nr]
        sd[f"merge{s}.conv_r.bias"] = concat_sd[first + "conv.bias"]
        sd[f"merge{s}.conv_c.weight"] = w[:, nr:]
        for k in ("weight", "bias", "running_mean", "running_var"):
            sd[f"merge{s}.bn.{k}"] = concat_sd[first + "bn." + k]
        for k, v in concat_sd.items():
            if k.startswith(f"five{s}.layers.") and not k.startswith(first):
                i = int(k.split(".")[2])
                sd[k.replace(f"layers.{i}.", f"layers.{i - 1}.", 1)] = v
    return sd


def test_fused_equals_concat_by_param_surgery():
    """The port's fused model equals its concat model within 1e-5 on the
    same input, the concat weights moved over by param surgery (as
    ``tests/test_yolov3.py::test_lateral_merge_exactness`` for JAX)."""
    images, _, _, concat = v3_setup(HW, False)
    fused = YOLOv3(image_size=HW, device="cpu").eval()
    fused.load_state_dict(_concat_to_fused(concat.state_dict()))
    x = torch.tensor(images[:2])
    with torch.no_grad():
        for yc, yf in zip(concat(x), fused(x)):
            torch.testing.assert_close(yf, yc, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fused", [True, False])
def test_bridge_round_trips_exactly(shared, fused):
    """The port's tree has exactly ``YOLOv3.init``'s leaves (traced with
    ``jax.eval_shape``, not compiled), in both formulations; flax tree ->
    ``state_dict`` -> flax tree leaf for leaf; 61 652 353 parameters."""
    model = shared["model"] if fused else v3_setup(HW, False)[3]
    jmodel = JaxYOLOv3(image_size=HW, fused_lateral=fused)
    ref = jax.eval_shape(jmodel.init, jax.random.key(0),
                         jnp.zeros((1, *HW, 3), jnp.uint8))
    tree = jax_from_state_dict(model.state_dict())
    assert jax.tree.structure(ref) == jax.tree.structure(tree)
    for r, a in zip(jax.tree.leaves(ref), jax.tree.leaves(tree)):
        assert r.shape == a.shape and r.dtype == a.dtype
    back = jax_from_state_dict(state_dict_from_jax(tree))
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(tree), jax.tree.leaves(back)))
    assert sum(p.numel() for p in model.parameters()) == 61_652_353
    fresh = copy.deepcopy(model)
    with torch.no_grad():
        for p in fresh.parameters():
            p.zero_()
    load_jax_yolov3(fresh, tree)
    loaded = fresh.state_dict()
    assert all(torch.equal(loaded[k], v)
               for k, v in model.state_dict().items())
    # Flax numbers by creation order: ConvBnLeaky_1 is t4, not a head.
    np.testing.assert_array_equal(
        state_dict_from_jax(tree)["reduce16.conv.weight"].numpy(),
        tree["params"]["ConvBnLeaky_1"]["Conv_0"]["kernel"].transpose(
            3, 2, 0, 1))


def test_registry_and_config():
    """``YOLOv3`` is in the registry, built from ``MODEL_CONFIG`` (mode
    "v3", 3 anchors a head, the 9 pixel anchors); without a card the
    default device raises instead of falling back to the CPU."""
    model = model_from_config(MODEL_CONFIG["YOLOv3"], device="meta")
    assert isinstance(model, YOLOv3) and model.mode == "v3"
    assert model.image_size == (416, 416) and model.num_anchor_box == 3
    assert model.anchors == tdecode.YOLOV3_ANCHORS == jdecode.YOLOV3_ANCHORS
    assert MODEL_REGISTRY["YOLOv3"] is YOLOv3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            get_model("YOLOv3")
    with pytest.raises(ValueError, match="9"):
        YOLOv3(anchors=tdecode.YOLOV3_ANCHORS[:6], device="meta")


# -- decode ----------------------------------------------------------------


def test_decode_v3_matches_jax():
    """``decode_v3`` against the JAX package's at two input sizes: every
    field within rtol 1e-6, box corners also atol 1e-4 px; the flat box
    axis is head by head, coarsest first."""
    rng = np.random.default_rng(4)
    for hw in ((416, 416), (96, 128)):
        ys = [rng.normal(0, 1.5, (2, hw[0] // s, hw[1] // s, 3, 25))
              .astype(np.float32) for s in (32, 16, 8)]
        ref = jax.jit(jdecode.decode_v3, static_argnums=1)(
            [jnp.asarray(y) for y in ys], hw)
        got = tdecode.decode_v3([torch.tensor(y) for y in ys], hw)
        for field in tdecode.Detections._fields:
            np.testing.assert_allclose(
                getattr(got, field).numpy(), np.asarray(getattr(ref, field)),
                rtol=1e-6, atol=1e-4 if field == "boxes" else 0,
                err_msg=f"{hw} {field}")
    g = 3 * (13 * 13 + 26 * 26 + 52 * 52)
    got = tdecode.decode_v3([torch.zeros(1, 416 // s, 416 // s, 3, 25)
                             for s in (32, 16, 8)], (416, 416))
    assert got.boxes.shape == (1, g, 4) and g == 10647
    # The first box is the coarsest head's first cell with the largest
    # anchor group's first prior (116 x 90 px) at its center (16, 16).
    np.testing.assert_allclose(got.boxes[0, 0].numpy(),
                               [16 - 58, 16 - 45, 16 + 58, 16 + 45])


# -- int8_dynamic ----------------------------------------------------------


def _int8_model(shared):
    model = YOLOv3(image_size=HW, int8_dynamic=True, device="cpu").eval()
    model.load_state_dict(shared["model"].state_dict())
    return model


@pytest.mark.parametrize("n", [16, 15])
def test_conv_i8_stride2_same_is_bitwise_xla(n):
    """The 3x3 stride-2 SAME int8 conv (Darknet-53's downsample) on an even
    and an odd size: the port's int32 accumulator equals XLA's
    ``conv_general_dilated(..., "SAME", preferred_element_type=int32)``
    exactly, full code range; on the CPU the GEMM runs its plain
    version."""
    rng = np.random.default_rng(n)
    x = rng.integers(-127, 128, (2, n, n, 128)).astype(np.int8)
    w = rng.integers(-127, 128, (3, 3, 128, 64)).astype(np.int8)
    dn = jax.lax.conv_dimension_numbers(x.shape, w.shape,
                                        ("NHWC", "HWIO", "NHWC"))
    ref = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
        dimension_numbers=dn, preferred_element_type=jnp.int32))
    launches = matmul.launches
    pads = (same_padding(n, 3, 2), same_padding(n, 3, 2))
    got = tquant.conv_i8(torch.tensor(x), torch.tensor(w), stride=2,
                         pads=pads)
    assert matmul.launches == launches
    assert got.dtype == torch.int32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


def _flax_block(block):
    """A port ``ConvBnLeaky``'s weights as flax ``ConvBnLeaky`` variables."""
    def a(t):
        return t.detach().numpy()

    return {"params": {
        "Conv_0": {"kernel": a(block.conv.weight).transpose(2, 3, 1, 0),
                   "bias": a(block.conv.bias)},
        "BatchNorm_0": {"scale": a(block.bn.weight), "bias": a(block.bn.bias)}},
        "batch_stats": {"BatchNorm_0": {"mean": a(block.bn.running_mean),
                                        "var": a(block.bn.running_var)}}}


def test_int8_dynamic_matches_jax(shared, monkeypatch):
    """``int8_dynamic`` against the JAX package's eager ``int8_dynamic`` on
    the same weights and images.

    Layer by layer: each of the 32 int8 convs (with its BN and leaky), fed
    the input the port's forward gave it, against flax's
    ``ConvBnLeaky(int8_dynamic=True)`` on that input: within 2e-6 (measured
    4.8e-7, one ulp at 4: the f32 epilogue).  The first int8 layer (the
    stride-2 downsample into stage 3, 128 -> 256 channels) on JAX's own
    input: the same codes and scales and the same int32 accumulator, bit
    for bit.

    The heads: relative l2 within 0.5 of JAX's int8 heads (measured 0.18,
    0.24, 0.29).  The two f32 forwards differ by 7e-5, which flips a few
    int8 codes, and the random network amplifies each flip: the same
    network's int8 heads are 0.24-0.42 off its own f32 heads."""
    model = _int8_model(shared)
    calls, seen = [], {}
    real = tquant.conv_i8

    def counted(*args, **kwargs):
        calls.append(args[1].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(tquant, "conv_i8", counted)
    blocks = {n: m for n, m in model.named_modules()
              if isinstance(m, ConvBnLeaky) and m.conv.kernel_size == (3, 3)}
    hooks = [m.register_forward_hook(
        lambda mod, args, out, n=n: seen.__setitem__(n, (args[0], out)))
        for n, m in blocks.items()]
    x = torch.tensor(shared["images"])
    with torch.no_grad():
        got = [y.numpy() for y in model(x)]
    for h in hooks:
        h.remove()
    assert len(calls) == INT8_LAYERS
    int8_layers = {n: v for n, v in seen.items() if v[0].shape[-1] >= 128}
    assert len(int8_layers) == INT8_LAYERS
    for name, (xi, yo) in int8_layers.items():
        blk = blocks[name]
        jblock = JaxConvBnLeaky(blk.conv.out_channels, (3, 3),
                                strides=(blk.stride,) * 2, int8_dynamic=True)
        ref = np.asarray(jblock.apply(_flax_block(blk),
                                      jnp.asarray(xi.numpy())))
        np.testing.assert_allclose(yo.numpy(), ref, rtol=0, atol=2e-6,
                                   err_msg=name)

    ys, inter = JaxYOLOv3(image_size=HW, int8_dynamic=True).apply(
        shared["jv"], jnp.asarray(shared["images"]),
        capture_intermediates=lambda mdl, _: mdl.name == "_Residual_2")
    for g, r in zip(got, ys):
        r = np.asarray(r)
        assert g.shape == r.shape and np.isfinite(g).all()
        assert np.linalg.norm(g - r) <= 0.5 * np.linalg.norm(r)
    # The first int8 layer on JAX's input to it (the output of stage 2).
    h = np.asarray(
        inter["intermediates"]["Darknet53Backbone_0"]["_Residual_2"]
        ["__call__"][0])
    assert h.shape == (CALIB_IMAGES, 16, 16, 128)
    xq, sx = tquant.quantize_dynamic(torch.tensor(h))
    jxq, jsx = jquant.quantize_dynamic(jnp.asarray(h))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    assert float(sx) == float(jsx)
    kernel = shared["variables"]["params"]["Darknet53Backbone_0"][
        "ConvBnLeaky_3"]["Conv_0"]["kernel"]
    wq, sw = tquant.quantize_weights_per_channel(torch.tensor(kernel))
    jwq, jsw = jquant.quantize_weights_per_channel(jnp.asarray(kernel))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw))
    acc = real(xq, wq, stride=2, pads=model.backbone.stages[2][0].pads(16, 16))
    dn = jax.lax.conv_dimension_numbers(jxq.shape, jwq.shape,
                                        ("NHWC", "HWIO", "NHWC"))
    jacc = jax.lax.conv_general_dilated(
        jxq, jwq, (2, 2), "SAME", dimension_numbers=dn,
        preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))


def _int8_layer_errors(model, images):
    """Relative l2 of each int8 layer's output in a forward of ``model``
    against the f32 ``ConvBnLeaky`` (the same block with int8 off) on the
    layer's own input."""
    seen = {}
    hooks = [m.register_forward_hook(
        lambda mod, args, out, n=n: seen.__setitem__(n, (args[0], out)))
        for n, m in model.named_modules()
        if isinstance(m, ConvBnLeaky) and m.conv.kernel_size == (3, 3)]
    with torch.no_grad():
        model(images)
        for h in hooks:
            h.remove()
        errs = {}
        for name, (x, y) in seen.items():
            if x.shape[-1] >= 128:
                block = dict(model.named_modules())[name]
                block.int8_dynamic = False
                ref = block(x)
                block.int8_dynamic = True
                errs[name] = float((y - ref).norm() / ref.norm())
    return errs


def test_int8_layers_within_the_card_bound(shared, monkeypatch):
    """The layer check of ``chip_smoke.py`` phase ``yolov3``, on the CPU:
    every one of the 32 int8 layers within 2^-4 relative l2 of its f32
    conv on the same input (measured 0.013-0.020), and with 4-bit codes
    (step amax / 7) every layer beyond it (measured 0.19-0.33)."""
    model = _int8_model(shared)
    x = torch.tensor(shared["images"])
    errs = _int8_layer_errors(model, x)
    assert len(errs) == INT8_LAYERS and max(errs.values()) <= 2.0 ** -4

    def four_bit(h):
        hf = h.float()
        scale = hf.abs().amax().clamp_min(1e-8) / 7.0
        return torch.clamp(torch.round(hf / scale), -7, 7).to(torch.int8), \
            scale

    monkeypatch.setattr(tquant, "quantize_dynamic", four_bit)
    control = _int8_layer_errors(model, x)
    assert min(control.values()) > 2.0 ** -4


def test_int8_dynamic_is_ignored_in_training_mode(shared, monkeypatch):
    """In training mode an ``int8_dynamic`` model runs no int8 conv and
    gives the bf16 model's heads bit for bit (batch-statistics BN on both);
    in eval mode it does run them."""
    model = _int8_model(shared)
    plain = YOLOv3(image_size=HW, device="cpu")
    plain.load_state_dict(shared["model"].state_dict())

    def refuse(*args, **kwargs):
        raise AssertionError("an int8 conv ran in training mode")

    monkeypatch.setattr(tquant, "conv_i8", refuse)
    x = torch.tensor(shared["images"][:2])
    with torch.no_grad():
        for a, b in zip(model.train()(x), plain.train()(x)):
            assert torch.equal(a, b)
    with pytest.raises(AssertionError, match="training mode"):
        with torch.no_grad():
            model.eval()(x)


# -- make_infer_fn ---------------------------------------------------------


def _gap_conf(ys):
    conf = np.concatenate([(1 / (1 + np.exp(-y[..., 4].astype(np.float64))))
                           .reshape(len(y), -1) for y in ys], 1)
    return gap_threshold(conf, conf.size // 8, conf.size // 2)


@pytest.mark.parametrize("compact,class_wise", [(False, False), (True, True)])
def test_infer_matches_jax(shared, compact, class_wise, monkeypatch):
    """``make_infer_fn`` on YOLOv3 against the JAX package's (eager: a
    jitted JAX forward fuses the BN into other ops and moves confidences
    by up to 2e-5 more), the
    threshold in a gap of the 252 candidates' confidences an image: keep
    masks and labels equal, boxes within 1e-4 of the largest coordinate,
    confidences and scores within 2e-5.  No superstem; the NMS wrapper
    runs its plain version on the CPU."""
    images = shared["images"]
    thre = _gap_conf(shared["ys"])
    kw = dict(conf_thre=thre, iou_thre=0.5, max_keep=64,
              class_wise=class_wise, compact=compact)
    ref = [np.asarray(a) for a in jdetect.make_infer_fn(
        shared["jmodel"], **kw)(shared["jv"], jnp.asarray(images))]

    def no_superstem(*args, **kwargs):
        raise AssertionError("the superstem ran on a YOLOv3")

    monkeypatch.setattr(tdetect, "superstem", no_superstem)
    launches = suppress.launches
    got = [t.numpy() for t in
           tdetect.make_infer_fn(shared["model"], **kw)(torch.tensor(images))]
    assert suppress.launches == launches
    keep = ref[-1]
    assert 0 < keep.sum() < keep.size
    np.testing.assert_array_equal(got[-1], keep)
    np.testing.assert_allclose(got[0], ref[0], rtol=0,
                               atol=1e-4 * np.abs(ref[0]).max())
    for r, g in zip(ref[1:-1], got[1:-1]):
        if r.dtype == np.int32:
            np.testing.assert_array_equal(g, r)
        else:
            np.testing.assert_allclose(g, r, rtol=0, atol=2e-5)
    assert got[0].shape == (CALIB_IMAGES, 64, 4)


def test_infer_refuses_the_yolov2_int8_paths(shared):
    """A YOLOv3 has no neck: ``int8_scales``/``int8_neck`` are refused (its
    int8 is the model's ``int8_dynamic``), and so is the native-size
    path."""
    model = shared["model"]
    for kw in (dict(int8_neck=True), dict(int8_scales=np.ones((22, 2)))):
        with pytest.raises(ValueError, match="require a YOLOv2"):
            tdetect.make_infer_fn(model, **kw)
    with pytest.raises(ValueError, match="YOLOv2 only"):
        tdetect.make_native_infer_fn(model)


def test_int8_dynamic_infer_runs_32_gemms_a_call(shared, monkeypatch):
    """``make_infer_fn`` of an ``int8_dynamic`` YOLOv3: every call runs the
    32 int8 convs and one suppression; the kept boxes are finite."""
    model = _int8_model(shared)
    convs = []
    real = tquant.conv_i8
    monkeypatch.setattr(tquant, "conv_i8",
                        lambda *a, **k: convs.append(1) or real(*a, **k))
    infer = tdetect.make_infer_fn(model, conf_thre=0.0, max_keep=16)
    boxes, conf, cls, keep = infer(torch.tensor(shared["images"][:2]))
    assert len(convs) == INT8_LAYERS
    assert keep.shape == (2, 16) and bool(keep.any())
    assert bool(torch.isfinite(boxes).all() and torch.isfinite(cls).all())
