"""The YOLOv4 configuration's reference (``reference/yolov4.py``) against
the program at small sizes in float32 on the CPU: the forward, decode with
grid sensitivity, the judge; the FLOP and parameter counts against the
program at 608 x 608; a whole small run of the cell, sound, with a fault
and with the float8 control; and the cell's metric files."""

import time
import types

import pytest
import torch

from benchmark import counts, epilogue_counts, harness
from benchmark.reference import calibrate, detect, nets, yolov4
from benchmark.run import execute
from benchmark.tools import faults

CELL = "yolov4-608.bulk-b64"
DRIVER = harness.load_module("drivers", "bulk_yolov4")


def config(hw=64):
    cfg = harness.load_json("configs", "yolov4-608")
    cfg["image_size"] = [hw, hw]
    return cfg


def images(n, hw, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, hw, hw, 3), generator=g, dtype=torch.uint8)


def weights(cfg, seed=3):
    sd = nets.make_weights(cfg, seed, "cpu")
    calibrate.calibrate_bn(cfg, sd, images(4, cfg["image_size"][0], seed), seed)
    return sd


def program(cfg, sd):
    return DRIVER.program_model(dict(cfg, compute_dtype="float32"), sd, "cpu").eval()


def test_forward_matches_the_program():
    cfg = config()
    sd = weights(cfg)
    x = images(2, 64, 9)
    with torch.no_grad():
        got = program(cfg, sd)(x)
        want = yolov4.YOLOv4Ref(cfg, sd).forward(x)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())


def test_decode_nms_and_judge_match_the_program():
    from odc_tpu_torch.ops.detect import make_infer_fn

    cfg = config(96)
    sd = weights(cfg)
    x = images(4, 96, 11)
    ref = DRIVER.reference_candidates(cfg, sd, x, 2)
    assert ref.conf.shape == (4, 3 * (3 * 3 + 6 * 6 + 12 * 12))
    thr = calibrate.gap_threshold(ref.conf, 8 * 4, 48 * 4)
    out = make_infer_fn(program(cfg, sd), thr, 0.5, 64, compact=True)(x)
    want = detect.served_format(ref, thr, 0.5, 64)
    assert torch.equal(out[4], want[4])  # the same boxes survive
    assert torch.equal(out[2], want[2].int())  # the same labels
    assert float((out[0] - want[0]).abs().max()) < 1e-3  # pixels
    for i in (1, 3):
        assert float((out[i] - want[i]).abs().max()) < 1e-4
    mix = dict(reference_block=2, iou_thre=0.5, max_keep=64)
    r = DRIVER.judge_calls(cfg, sd, [x], [out], thr, mix)
    assert r["served"] > 0 and r["missed"] == 0.0 and r["overlap"] == 0.0
    assert r["conf_gap"] < 1e-4 and r["size_gap"] < 1e-4 and r["label_gap"] < 1e-4


def test_the_judge_finds_a_centre_moved_out_of_its_cell():
    """A candidate whose grid-sensitive centre lies in the next cell is
    still tied to itself: ``detect.judge`` would look in the wrong cell."""
    cfg = config(64)
    n, g = 1, 3 * (2 * 2 + 4 * 4 + 8 * 8)
    boxes = torch.zeros(n, g, 4)
    conf = torch.full((n, g), 0.01)
    score = torch.full((n, g, 20), 0.001)
    # Stride-8 head, cell (row 3, col 3), anchor 0: centre x at 32.4, in
    # column 4 (s = 1.2 lets sigmoid(tx) * 1.2 - 0.1 reach 1.05).
    off = 3 * (4 + 16)
    i = off + (3 * 8 + 3) * 3
    boxes[0, i] = torch.tensor([26.4, 22.0, 38.4, 34.0])
    conf[0, i] = 0.9
    score[0, i, 7] = 0.8
    ref = detect.Candidates(boxes, conf, score)
    served = dict(boxes=boxes[:, i:i + 1].clone(), conf=conf[:, i:i + 1].clone(),
                  label=torch.tensor([[7]]), label_score=torch.tensor([[0.8]]),
                  keep=torch.tensor([[True]]))
    r = yolov4.judge(cfg, ref, served, 0.5, 0.5, 64)
    assert r["conf_gap"] == 0.0 and r["size_gap"] == 0.0 and r["label_gap"] == 0.0
    assert detect.judge(cfg, ref, served, 0.5, 0.5, 64)["conf_gap"] > 0.5


def test_the_judge_ties_by_the_label_score_where_two_boxes_fit():
    """A served box 30% wider than its source (bf16's reach on YOLOv4's
    widths) fits the next anchor's box better; its objectness and its
    label's score still tie it to the source, whose best class it serves."""
    cfg = config(64)
    n, g = 1, 3 * (2 * 2 + 4 * 4 + 8 * 8)
    boxes = torch.zeros(n, g, 4)
    conf = torch.full((n, g), 0.01)
    score = torch.full((n, g, 20), 0.001)
    i = 3 * (4 + 16) + (3 * 8 + 3) * 3  # stride 8, cell (3, 3), anchor 0
    boxes[0, i] = torch.tensor([22.0, 22.0, 32.0, 32.0])
    boxes[0, i + 1] = torch.tensor([20.5, 22.0, 33.5, 32.0])
    conf[0, i], conf[0, i + 1] = 0.90, 0.86
    score[0, i, 3], score[0, i, 5] = 0.70, 0.40
    score[0, i + 1, 3], score[0, i + 1, 5] = 0.20, 0.65
    ref = detect.Candidates(boxes, conf, score)
    served = dict(boxes=torch.tensor([[[20.5, 22.0, 33.5, 32.0]]]),
                  conf=torch.tensor([[0.89]]), label=torch.tensor([[3]]),
                  label_score=torch.tensor([[0.69]]), keep=torch.tensor([[True]]))
    assert yolov4.tie(cfg, ref, served).tolist() == [[i]]
    r = yolov4.judge(cfg, ref, served, 0.5, 0.5, 64)
    assert r["label_gap"] == 0.0 and r["conf_gap"] < 0.02
    # A wrong label served with its own score on the source's box stays
    # tied to the source, and its gap shows.
    served = dict(boxes=boxes[:, i:i + 1].clone(), conf=conf[:, i:i + 1].clone(),
                  label=torch.tensor([[5]]), label_score=torch.tensor([[0.40]]),
                  keep=torch.tensor([[True]]))
    assert yolov4.tie(cfg, ref, served).tolist() == [[i]]
    assert yolov4.judge(cfg, ref, served, 0.5, 0.5, 64)["label_gap"] > 0.29


def test_scale_x_y_of_the_decode_matches_the_program():
    from odc_tpu_torch.ops.decode import decode_v3

    cfg = config(64)
    g = torch.Generator().manual_seed(4)
    heads = tuple(3 * torch.randn(2, 64 // s, 64 // s, 3, 25, generator=g)
                  for s in (32, 16, 8))
    want = yolov4.decode(cfg, heads)
    got = decode_v3(heads, (64, 64), [tuple(a) for a in cfg["anchors"]],
                    scale_x_y=cfg["scale_x_y"])
    assert float((got.boxes - want.boxes).abs().max()) < 1e-4
    assert torch.equal(got.conf, want.conf)


def test_flop_and_parameter_counts_match_the_program():
    from torch.utils.flop_counter import FlopCounterMode

    cfg = harness.load_json("configs", "yolov4-608")
    model = program(cfg, nets.make_weights(cfg, 1, "cpu"))
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(torch.zeros(1, 608, 608, 3, dtype=torch.uint8))
    assert abs(fc.get_total_flops() - yolov4.conv_flops_per_image(cfg)) < 1e6
    assert counts.conv_flops_per_image(cfg) == yolov4.conv_flops_per_image(cfg)
    assert round(yolov4.conv_flops_per_image(cfg) / 1e9, 3) == cfg["forward_gflop_per_image"]
    assert nets.param_count(cfg) == cfg["params"] == sum(
        p.numel() for p in model.parameters())
    from odc_tpu_torch.models.layers import ConvBnLeaky

    mish = [m for m in model.modules()
            if isinstance(m, ConvBnLeaky) and m.activation == "mish"]
    assert len(mish) == len(yolov4.mish_maps(cfg)) == 72


def test_the_hook_leaves_the_other_models_alone():
    for name, gflop in (("yolov2-416", 34.90), ("yolov3-416", 65.30)):
        cfg = harness.load_json("configs", name)
        assert round(counts.conv_flops_per_image(cfg) / 1e9, 2) == gflop
        assert nets.param_count(cfg) == cfg["params"]
    assert nets.NETS["YOLOv4"] is yolov4.YOLOv4Ref


# The cell's own band of kept boxes (8-48 an image) at a small size.
SMALL = dict(batch=4, distinct_batches=2, judged_calls=2, warmup_calls=1,
             reference_block=4)


def small_cell(hw=96):
    cell = harness.load_json("workloads", CELL)
    cfg = harness.load_json("configs", cell["config"])
    cfg["image_size"] = [hw, hw]
    cell["mix"].update(SMALL)
    return cell, cfg


@pytest.mark.parametrize("seed", (0, 2**31 + 5, 2**33 + 7))
def test_the_judged_batches_depend_on_the_seed_alone(seed):
    # A faster program runs more calls at the same seed; it judges the same
    # batches all the same, each on its first call.
    picks = {tuple(DRIVER.judged_batches(seed, 4, calls, 2))
             for calls in (4, 5, 97, 1200)}
    assert len(picks) == 1
    (picked,) = picks
    assert len(set(picked)) == 2 and all(0 <= b < 4 for b in picked)
    assert all(b < 3 for b in DRIVER.judged_batches(seed, 4, 3, 2))
    assert DRIVER.judged_batches(seed, 4, 1, 2) == [0]


@pytest.mark.parametrize("fault", (None,) + faults.FAULTS)
def test_a_small_run_is_correct_unless_broken(monkeypatch, fault):
    if fault is not None:
        faults.plant(fault, monkeypatch.setattr)
    cell, cfg = small_cell()
    result, checks = execute(cell, cfg, 2**31 + 11, 0.3, False, "cpu",
                             time.perf_counter(), log=lambda s: None)
    assert result["correct"] == (fault is None), checks
    if fault == "nosuppress":
        assert checks["overlap"][0] > checks["overlap"][1], checks


def test_the_control_fails_at_a_small_size():
    cell, cfg = small_cell(160)
    cell["mix"].update(batch=8, reference_block=8)
    ctx = types.SimpleNamespace(cell=cell, cfg=cfg, seed=2**31 + 17, device="cpu",
                                trace=False, recorder=harness.Recorder(False),
                                mark=lambda name: None)
    numbers = DRIVER.control(DRIVER.setup(ctx))
    assert {k for k, lim in cell["limits"].items() if numbers[k] > lim}


def test_metrics_read_a_hand_built_trace():
    cfg = harness.load_json("configs", "yolov4-608")
    tr = harness.Trace(cell={"name": CELL}, config=cfg, window_s=10.0)
    tr.counters.update(images=6400, batch=64)
    maps = yolov4.mish_maps(cfg)
    bound = epilogue_counts.bias_bn_mish_bound_s(64, maps)
    elements = 64 * sum(h * w * c for h, w, c in maps)
    assert bound == pytest.approx(4 * elements / counts.HBM_BPS, rel=1e-4)
    tr.kernels = {"bias_bn_mish_kernel": (100 * 2 * bound, 100 * 72)}
    roof = harness.load_module("metrics", "mish_epilogue_roofline")
    assert roof.read(tr) == pytest.approx(50.0)
    mfu = harness.load_module("metrics", "mfu.infer.yolov4")
    assert mfu.read(tr) == pytest.approx(
        100 * 6400 * 127.457929216e9 / 10.0 / counts.BF16_FLOPS)
    tr.kernels = {}
    assert roof.read(tr) is None
    for name in ("bn_mish_ms.infer", "spp_ms.infer"):
        assert harness.load_module("metrics", name).read(tr) is None  # no spans
