"""What a run loads and refuses: no JAX module and no module of the JAX
package in a run's process (top-level names compared whole: the port's
name begins with the JAX package's), the reference free of the program,
and no result without a card."""

import ast
import json
import pathlib
import subprocess
import sys

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "odc_tpu"}


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in harness.BENCH.rglob("*.py"):
        assert not set(_imports(path)) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (harness.BENCH / "reference").rglob("*.py"):
        assert "odc_tpu_torch" not in set(_imports(path)), path
    for path in (harness.BENCH / "counts.py",):
        assert "odc_tpu_torch" not in set(_imports(path)), path


def test_a_run_loads_no_jax_module():
    """A whole small run on the CPU, in a fresh process, then
    ``sys.modules`` by top-level name."""
    code = f"""
import json, sys, time
sys.path.insert(0, {str(harness.ROOT)!r})
from benchmark import harness
from benchmark.run import execute
for name in harness.names("workloads"):
    cell = harness.load_json("workloads", name)
    cfg = harness.load_json("configs", cell["config"])
    harness.load_module("drivers", cell["driver"])
    harness.metrics_for(name)
cell = harness.load_json("workloads", "yolov2-416.bulk-b64")
cfg = harness.load_json("configs", "yolov2-416")
cfg["image_size"] = [64, 64]
cell["mix"].update(batch=2, distinct_batches=1, judged_calls=1, warmup_calls=1,
                   keep_lo=2, keep_hi=8)
execute(cell, cfg, 1, 0.1, False, "cpu", time.perf_counter(), log=lambda s: None)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "odc_tpu_torch" in loaded and "benchmark" in loaded
    assert not loaded & FORBIDDEN
    assert harness.forbidden_modules(["odc_tpu.models", "jax"]) == ["jax", "odc_tpu"]
    assert harness.forbidden_modules(["odc_tpu_torch.ops", "jaxtyping"]) == []


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        return  # the refusal is for machines without a card
    out = subprocess.run(
        [sys.executable, str(harness.BENCH / "run.py"), "--workload",
         "yolov2-416.bulk-b64", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr
