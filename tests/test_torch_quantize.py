"""The port's int8 quantization (``odc_tpu_torch/ops/quantize.py``) against
``odc_tpu.ops.quantize`` and the JAX engine's int8 convolution on the CPU:
codes and scales, the int32 conv accumulators (bitwise: im2col + the GEMM's
plain version against XLA's int32 conv), the quantized neck block, the
``neck_override`` hook, and ``make_infer_fn(int8_neck=True)`` end to end."""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax import lax

from odc_tpu.models.layers import ConvBnLeaky as JConvBnLeaky
from odc_tpu.ops import quantize as jq
from odc_tpu.ops.detect import jit_infer_fn
from odc_tpu.ops.int8_engine import _conv_i8
from odc_tpu_torch.models.layers import ConvBnLeaky
from odc_tpu_torch.ops import quantize as tq
from odc_tpu_torch.ops.cuda.matmul_kernel import matmul
from odc_tpu_torch.ops.cuda.nms_kernel import suppress
from odc_tpu_torch.ops.cuda.superstem_kernel import superstem
from odc_tpu_torch.ops.decode import YOLOV2_ANCHORS
from odc_tpu_torch.ops.detect import make_infer_fn, stem_weights
from torch_port_helpers import int8_parity_setup, port_model


@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_quantize_dynamic_matches_jax(dtype):
    """Codes and scale bit for bit, from f32 and from bf16 activations."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2.0, (4, 7, 7, 16)).astype(np.float32)
    if dtype == "bf16":
        jx = jnp.asarray(x, jnp.bfloat16)
        tx = torch.tensor(x).bfloat16()
    else:
        jx, tx = jnp.asarray(x), torch.tensor(x)
    q_ref, s_ref = jq.quantize_dynamic(jx)
    q, s = tq.quantize_dynamic(tx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    assert s.item() == float(s_ref)


def test_quantize_weights_per_channel_matches_jax():
    rng = np.random.default_rng(1)
    k = rng.normal(0, 0.1, (3, 3, 8, 16)).astype(np.float32)
    k[..., 3] = 0.0  # an all-zero channel takes the 1e-8 floor
    q_ref, s_ref = jq.quantize_weights_per_channel(jnp.asarray(k))
    # The port takes HWIO too: here the view of a PyTorch OIHW weight.
    q, s = tq.quantize_weights_per_channel(
        tq.hwio(torch.tensor(k).permute(3, 2, 0, 1)))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))


def _lifted_i8(x, w):
    """The JAX engine's lifted int8 conv (``int8_engine.py``, stem='s2d2'):
    4x4/stride 2, one row/col of padding a side, int32 accumulation."""
    dn = lax.conv_dimension_numbers(x.shape, w.shape, ("NHWC", "HWIO", "NHWC"))
    return lax.conv_general_dilated(
        x, w, (2, 2), [(1, 1), (1, 1)], dimension_numbers=dn,
        preferred_element_type=jnp.int32)


@pytest.mark.parametrize(
    "k, stride, cin, cout, hw",
    [(1, 1, 64, 40, (7, 9)),     # 1x1: no im2col
     (1, 1, 20, 8, (5, 6)),      # 1x1 with K padded from 20 to 32
     (3, 1, 32, 64, (9, 10)),    # 3x3 SAME
     (3, 1, 3, 32, (12, 16)),    # the plain stem: K = 27 padded to 32
     (4, 2, 32, 256, (10, 12))],  # the lifted conv of stem='s2d2'
    ids=["1x1", "1x1-padded-k", "3x3", "3x3-stem", "lifted"],
)
def test_conv_i8_accumulator_is_bitwise_xla(k, stride, cin, cout, hw):
    """Fed the same int8 codes (full range, -128 included), the port's
    int32 accumulator equals XLA's int32 conv exactly."""
    rng = np.random.default_rng(k * 10 + cin)
    x = rng.integers(-128, 128, (2, *hw, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    if stride == 1:
        ref = _conv_i8(jnp.asarray(x), jnp.asarray(w))
    else:
        ref = _lifted_i8(jnp.asarray(x), jnp.asarray(w))
    launches = matmul.launches
    got = tq.conv_i8(torch.tensor(x), torch.tensor(w), stride=stride)
    assert matmul.launches == launches  # CPU: the plain GEMM
    assert got.dtype == torch.int32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize(
    "wshape, stride, xdtype, error",
    [((2, 2, 4, 4), 1, torch.int8, ValueError),
     ((3, 3, 4, 4), 2, torch.int8, ValueError),
     ((3, 3, 4, 4), 1, torch.float32, TypeError),
     ((3, 3, 5, 4), 1, torch.int8, ValueError)],
    ids=["2x2", "3x3-stride-2", "float", "channels"],
)
def test_conv_i8_rejects(wshape, stride, xdtype, error):
    x = torch.zeros(1, 6, 6, 4, dtype=xdtype)
    with pytest.raises(error):
        tq.conv_i8(x, torch.zeros(wshape, dtype=torch.int8), stride=stride)


def _jax_block(rng, cin, cout):
    """A flax ConvBnLeaky's variables with random BN statistics, as numpy,
    and the port's block holding the same weights."""
    v = jax.tree.map(np.asarray, JConvBnLeaky(cout, (3, 3)).init(
        jax.random.key(0), jnp.zeros((1, 4, 4, cin))))
    v["batch_stats"]["BatchNorm_0"] = {
        "mean": rng.normal(0, 0.2, cout).astype(np.float32),
        "var": rng.uniform(0.5, 1.5, cout).astype(np.float32)}
    v["params"]["BatchNorm_0"] = {
        "scale": rng.uniform(0.5, 1.5, cout).astype(np.float32),
        "bias": rng.normal(0, 0.1, cout).astype(np.float32)}
    block = ConvBnLeaky(cin, cout, 3).eval()
    p, s = v["params"], v["batch_stats"]["BatchNorm_0"]
    with torch.no_grad():
        block.conv.weight.copy_(torch.tensor(
            p["Conv_0"]["kernel"].transpose(3, 2, 0, 1)))
        block.conv.bias.copy_(torch.tensor(p["Conv_0"]["bias"]))
        block.bn.weight.copy_(torch.tensor(p["BatchNorm_0"]["scale"]))
        block.bn.bias.copy_(torch.tensor(p["BatchNorm_0"]["bias"]))
        block.bn.running_mean.copy_(torch.tensor(s["mean"]))
        block.bn.running_var.copy_(torch.tensor(s["var"]))
    return v, block


def test_int8_conv_bn_leaky_matches_jax():
    """Same codes, same exact accumulator, the same f32 epilogue op for op:
    within 2 f32 ulps of the output range (measured 0), in f32; in bf16 out
    within one bf16 ulp (rounding of values a few f32 ulps apart)."""
    rng = np.random.default_rng(2)
    v, block = _jax_block(rng, 96, 64)
    x = rng.normal(0, 1, (2, 13, 13, 96)).astype(np.float32)
    p, s = v["params"], v["batch_stats"]
    for out_dtype, jdt, ulps in ((torch.float32, jnp.float32, 2 ** -22),
                                 (torch.bfloat16, jnp.bfloat16, 2 ** -7)):
        ref = np.asarray(jq.int8_conv_bn_leaky(
            jnp.asarray(x), p["Conv_0"], p["BatchNorm_0"], s["BatchNorm_0"],
            out_dtype=jdt), np.float32)
        got = tq.int8_conv_bn_leaky(torch.tensor(x), block, out_dtype=out_dtype)
        assert got.dtype == out_dtype and got.shape == (2, 13, 13, 64)
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                                   atol=ulps * np.abs(ref).max())
    # And within PTQ error of the float block (a few percent of the range).
    with torch.no_grad():
        full = block(torch.tensor(x)).numpy()
    assert np.abs(full - ref).max() < 0.03 * np.abs(full).max()


@pytest.fixture(scope="module")
def shared():
    """(images, JAX model, jnp variables, port model in f32)."""
    images, jmodel, variables = int8_parity_setup()
    return (images, jmodel, jax.tree.map(jnp.asarray, variables),
            port_model(variables))


def test_neck_override_hook(shared):
    """``YOLOv2.forward(neck_override=...)`` replaces the neck conv in eval
    mode only: the block itself reproduces the plain forward bit for bit,
    and training mode ignores the hook."""
    images, _, _, model = shared
    x = torch.tensor(images)
    calls = []

    def neck(h):
        calls.append(h.shape)
        return model.neck(h)

    with torch.no_grad():
        plain = model(x)
        hooked = model(x, neck_override=neck)
        assert calls == [(2, 2, 3, 3072)]
        assert torch.equal(hooked, plain)
        # A copy: a training-mode forward moves the BN running statistics.
        copy.deepcopy(model).train()(x, neck_override=neck)
    assert len(calls) == 1


def test_infer_int8_neck_matches_jax(shared):
    """``make_infer_fn(int8_neck=True)`` against the JAX package's, f32
    model.  The port runs the fused stem's plain version (f32, BN folded)
    where JAX runs the unfused stem, and its convolutions sum in another
    order, so the neck input differs by about 7e-5 of its range, the
    dynamic scale by an ulp, and 3e-4 of the neck's codes by one level
    (measured).  The head then differs by 1.5e-3 of a range of 1.4
    (measured; held to 1e-2 of the range here, fed the same neck input to
    2.4e-7).  At a conf in the largest gap of the candidates, per image:
    the same kept count, every kept box within ``box_atol`` (the head bound
    carried through decode to pixels, as in test_torch_detect) of a kept
    box of the other side, its conf within 1e-3.  Order may differ: two
    kept boxes of confs within 1e-3 can trade places."""
    images, jmodel, jv, model = shared
    x = torch.tensor(images)
    p, st = jv["params"]["ConvBnLeaky_0"], jv["batch_stats"]["ConvBnLeaky_0"]
    y_ref = np.asarray(jmodel.apply(
        jv, jnp.asarray(images), train=False,
        neck_override=lambda h: jq.int8_conv_bn_leaky(
            h, p["Conv_0"], p["BatchNorm_0"], st["BatchNorm_0"],
            out_dtype=jnp.float32)))
    with torch.no_grad():
        y = model(x, stem_out=superstem(x, *stem_weights(model)),
                  neck_override=lambda h: tq.int8_conv_bn_leaky(
                      h, model.neck, out_dtype=torch.float32)).numpy()
    d_head = 1e-2 * np.abs(y_ref).max()
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=d_head)

    f8 = jit_infer_fn(jmodel, conf_thre=0.0, max_keep=64, int8_neck=True)
    conf = np.sort(np.asarray(f8(jv, images)[1]).ravel())[::-1][:40]
    r = int(np.argmax(conf[:-1] - conf[1:]))
    assert conf[r] - conf[r + 1] > 1e-3
    thre = float((conf[r] + conf[r + 1]) / 2)
    ref = [np.asarray(a) for a in f8(jv, images, thre, 0.5)]
    before = (superstem.launches, suppress.launches, matmul.launches)
    infer = make_infer_fn(model, conf_thre=thre, max_keep=64, int8_neck=True)
    got = [t.numpy() for t in infer(x)]
    assert (superstem.launches, suppress.launches, matmul.launches) == before
    assert 0 < ref[-1].sum() < ref[-1].size
    tw = np.abs(y_ref[..., 2:4]).max()
    box_atol = 32 * d_head * (0.25 + max(map(max, YOLOV2_ANCHORS))
                              * np.exp(tw) / 2)
    for i in range(images.shape[0]):
        (b_ref, c_ref), (b_got, c_got) = [
            (o[0][i][o[-1][i]], o[1][i][o[-1][i]]) for o in (ref, got)]
        assert len(b_ref) == len(b_got)
        dist = np.abs(b_ref[:, None] - b_got[None]).max(-1)
        assert (dist.min(1) < box_atol).all() and (dist.min(0) < box_atol).all()
        np.testing.assert_allclose(c_got[dist.argmin(1)], c_ref, rtol=0,
                                   atol=1e-3)
    # The quantized neck moved the detections off the f32 ones, a little.
    f32 = [t.numpy() for t in make_infer_fn(
        model, conf_thre=thre, max_keep=64)(x)]
    assert not np.array_equal(f32[1], got[1])
