"""The control of each inference cell, the reference computed in float8
and put in the program's place, fails the cell's own limits: at a size a
test run holds on the CPU here, and at the cell's own size on the card
(``python -m pytest benchmark/tests -m card`` there)."""

import types

import pytest

from benchmark import harness

SMALL = {
    "yolov2-416.bulk-b64": (160, dict(batch=8, distinct_batches=2, judged_calls=2,
                                      warmup_calls=1, reference_block=8)),
    "yolov3-416.bulk-b256": (160, dict(batch=8, distinct_batches=2, judged_calls=2,
                                       warmup_calls=1, reference_block=8)),
}


def failed_limits(cell, cfg, seed, device):
    driver = harness.load_module("drivers", cell["driver"])
    ctx = types.SimpleNamespace(cell=cell, cfg=cfg, seed=seed, device=device,
                                trace=False, recorder=harness.Recorder(False),
                                mark=lambda name: None)
    numbers = driver.control(driver.setup(ctx))
    return {k: numbers[k] for k, lim in cell["limits"].items() if numbers[k] > lim}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_control_fails_at_a_small_size(name):
    hw, mix = SMALL[name]
    cell = harness.load_json("workloads", name)
    cfg = harness.load_json("configs", cell["config"])
    cfg["image_size"] = [hw, hw]
    cell["mix"].update(mix)
    assert failed_limits(cell, cfg, 2**31 + 17, "cpu")


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_control_fails_at_the_cells_size(card, name):
    cell = harness.load_json("workloads", name)
    cfg = harness.load_json("configs", cell["config"])
    assert failed_limits(cell, cfg, 2**31 + 19, card)
