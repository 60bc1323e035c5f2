"""The per-layer metrics that read the program's own spans
(``program_spans.py``): read after a traced run of a tiny cell on the CPU,
and on the card, where every synchronising operation of a bulk call must
sit in a ``sync`` span (``python -m pytest benchmark/tests -m card``)."""

import time
import types
import warnings

import pytest

from benchmark import harness

HOST_SIDE = ("host_wait_ms.infer", "decode_nms_host_ms.infer", "host_syncs.infer")
DEVICE_SIDE = ("conv_ms.infer", "bn_leaky_ms.infer")


def test_a_traced_tiny_run_feeds_the_span_metrics():
    from odc_tpu_torch.utils import metrics

    from benchmark.run import execute

    cell = harness.load_json("workloads", "yolov2-416.bulk-b64")
    cfg = harness.load_json("configs", "yolov2-416")
    cfg["image_size"] = [64, 64]
    cell.update(name="tiny-v2.bulk-b2")
    cell["mix"].update(batch=2, distinct_batches=2, judged_calls=1,
                       warmup_calls=1, keep_lo=2, keep_hi=8)
    metrics.reset_spans()
    execute(cell, cfg, 2**31 + 7, 0.2, True, "cpu", time.perf_counter(),
            log=lambda s: None)
    read = {n: harness.load_module("metrics", n).read(None)
            for n in HOST_SIDE + DEVICE_SIDE}
    assert read["host_wait_ms.infer"] > 0
    assert read["decode_nms_host_ms.infer"] > 0
    # On the CPU the superstem's plain version normalizes: its two sites
    # beside decode's and the NMS's.
    assert read["host_syncs.infer"] == 4
    assert all(read[n] is None for n in DEVICE_SIDE)  # no device on the CPU
    metrics.reset_spans()


@pytest.mark.card
@pytest.mark.parametrize("name", ["yolov2-416.bulk-b64", "yolov3-416.bulk-b256"])
def test_every_sync_of_a_bulk_call_has_its_span(card, name):
    """One call at the cell's size under the profiler and
    ``set_sync_debug_mode("warn")``: as many synchronising operations as
    ``sync`` spans; the outputs bitwise those of an untraced call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from odc_tpu_torch.ops.detect import make_infer_fn
    from odc_tpu_torch.utils import metrics

    cell = harness.load_json("workloads", name)
    cfg = harness.load_json("configs", cell["config"])
    driver = harness.load_module("drivers", cell["driver"])
    ctx = types.SimpleNamespace(cell=cell, cfg=cfg, seed=2**31 + 11, device=card,
                                mark=lambda name: None)
    model = driver.program_model(cfg, driver.prepare(ctx), card)
    infer = make_infer_fn(model, 0.5, 0.5, cell["mix"]["max_keep"], compact=True)
    gen = torch.Generator(device=card).manual_seed(3)
    x = torch.randint(0, 256, (cell["mix"]["batch"], *cfg["image_size"], 3),
                      generator=gen, device=card, dtype=torch.uint8)
    for _ in range(2):
        off = [o.cpu() for o in infer(x)]
    metrics.reset_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = infer(x)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        on = [o.cpu() for o in out]
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    (call,) = metrics.spans_by_call().values()
    spans = [sp.attrs["site"] for sp in call if sp.name == "sync"]
    print(f"{name}: {len(syncs)} synchronising operations, sync spans {spans}")
    assert len(syncs) == len(spans)
    assert all(sp.device_ms is not None for sp in call if sp.name != "sync")
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    metrics.reset_spans()
