"""A whole run on the CPU, the look for a card skipped, with the timed path
broken underneath (``benchmark/tools/faults.py``): ``correct`` has to come
out false, once for each fault the cell can have (one chip: no exchange
between chips to leave out).  The cells' own limits, at a size a test run
holds."""

import time

import pytest

from benchmark import harness
from benchmark.run import execute
from benchmark.tools import faults

CELLS = ["yolov2-416.bulk-b64", "yolov3-416.bulk-b256"]
BULK = dict(batch=4, distinct_batches=2, judged_calls=2, warmup_calls=1,
            keep_lo=4, keep_hi=16, reference_block=4)


def run(cell_name, hw=96, seconds=0.3, seed=2**31 + 11):
    cell = harness.load_json("workloads", cell_name)
    cfg = harness.load_json("configs", cell["config"])
    cfg["image_size"] = [hw, hw]
    cell["mix"].update(BULK)
    return execute(cell, cfg, seed, seconds, False, "cpu", time.perf_counter(),
                   log=lambda s: None)


@pytest.mark.parametrize("cell_name", CELLS)
def test_a_sound_bulk_run_is_correct(cell_name):
    result, checks = run(cell_name)
    assert result["correct"], checks
    assert checks["overlap"][0] == 0.0


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell_name", CELLS)
def test_a_broken_bulk_path_is_not_correct(monkeypatch, cell_name, fault):
    faults.plant(fault, monkeypatch.setattr)
    result, checks = run(cell_name)
    assert not result["correct"], checks
    if fault == "nosuppress":  # the suppression's own number catches it
        assert checks["overlap"][0] > checks["overlap"][1], checks
