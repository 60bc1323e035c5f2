"""The benchmark's plain reference against the program at small sizes, in
float32 on the CPU: the forwards, decode and NMS, the judge, and the FLOP
counts against
``torch.utils.flop_counter`` on the program.  (The tests may import both;
the reference imports nothing of the program.)"""

import pytest
import torch

from benchmark import counts, harness
from benchmark.drivers import bulk
from benchmark.reference import calibrate, detect, nets


def config(name, hw=64):
    cfg = harness.load_json("configs", name)
    cfg["image_size"] = [hw, hw]
    return cfg


def images(n, hw, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, hw, hw, 3), generator=g, dtype=torch.uint8)


def weights(cfg, seed=3):
    sd = nets.make_weights(cfg, seed, "cpu")
    calibrate.calibrate_bn(cfg, sd, images(4, cfg["image_size"][0], seed), seed)
    return sd


def program(cfg, sd, dtype=torch.float32):
    c = dict(cfg, compute_dtype=str(dtype).removeprefix("torch."))
    return bulk.program_model(c, sd, "cpu").eval()


@pytest.mark.parametrize("name", ["yolov2-416", "yolov3-416"])
def test_forward_matches_the_program(name):
    cfg = config(name)
    sd = weights(cfg)
    x = images(2, 64, 9)
    with torch.no_grad():
        got = program(cfg, sd)(x)
        want = nets.net(cfg, sd).forward(x)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


@pytest.mark.parametrize("name", ["yolov2-416", "yolov3-416"])
def test_decode_nms_and_judge_match_the_program(name):
    from odc_tpu_torch.ops.detect import make_infer_fn

    cfg = config(name, 96)
    sd = weights(cfg)
    x = images(4, 96, 11)
    ref = bulk.reference_candidates(cfg, sd, x, 2)
    thr = calibrate.gap_threshold(ref.conf, 8 * 4, 48 * 4)
    out = make_infer_fn(program(cfg, sd), thr, 0.5, 64, compact=True)(x)
    want = detect.served_format(ref, thr, 0.5, 64)
    assert torch.equal(out[4], want[4])  # the same boxes survive
    assert torch.equal(out[2], want[2].int())  # the same labels
    # The program folds BN into the fused stem: float32 rounding apart.
    assert float((out[0] - want[0]).abs().max()) < 0.02  # pixels
    for i in (1, 3):
        assert float((out[i] - want[i]).abs().max()) < 1e-3
    mix = dict(reference_block=2, iou_thre=0.5, max_keep=64)
    r = bulk.judge_calls(cfg, sd, [x], [out], thr, mix)
    assert r["served"] > 0 and r["missed"] == 0.0 and r["overlap"] == 0.0
    assert r["conf_gap"] < 1e-3 and r["size_gap"] < 1e-3 and r["label_gap"] < 1e-3


def test_calibrated_network_keeps_order_one_activations():
    cfg = config("yolov2-416", 128)
    sd = weights(cfg)
    with torch.no_grad():
        y = nets.net(cfg, sd).forward(images(2, 128, 5))
    assert 0.1 < float(y.std()) < 10.0


@pytest.mark.parametrize("name,gflop", [("yolov2-416", 34.90), ("yolov3-416", 65.30)])
def test_flop_counts_match_the_program(name, gflop):
    from torch.utils.flop_counter import FlopCounterMode

    cfg = harness.load_json("configs", name)
    sd = nets.make_weights(cfg, 1, "cpu")
    model = program(cfg, sd)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(torch.zeros(1, 416, 416, 3, dtype=torch.uint8))
    assert abs(fc.get_total_flops() - counts.conv_flops_per_image(cfg)) < 1e6
    assert round(counts.conv_flops_per_image(cfg) / 1e9, 2) == gflop
    assert nets.param_count(cfg) == sum(p.numel() for p in model.parameters())


def test_weights_repeat_from_a_seed():
    cfg = config("yolov2-416")
    a, b = nets.make_weights(cfg, 2**31 + 5, "cpu"), nets.make_weights(cfg, 2**31 + 5, "cpu")
    c = nets.make_weights(cfg, 2**31 + 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["neck.conv.weight"], c["neck.conv.weight"])
