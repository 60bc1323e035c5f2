"""Every cell, configuration and per-layer metric is a file the harness
finds by name; BENCHMARK.json says the same as the files; a new cell,
configuration or metric is found without editing a file that is there."""

import json
import re
import shutil

import pytest

from benchmark import counts, harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCHMARK = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
E2E = {m["name"]: m for m in BENCHMARK["end_to_end"]}


def test_every_file_loads():
    cells = harness.names("workloads")
    assert cells
    for name in cells:
        cell = harness.load_json("workloads", name)
        harness.load_json("configs", cell["config"])
        driver = harness.load_module("drivers", cell["driver"])
        for fn in ("setup", "window", "trace_values", "check", "control"):
            assert callable(getattr(driver, fn)), (name, fn)
        assert set(cell["limits"]) and all(v >= 0 for v in cell["limits"].values())
    for name in harness.names("metrics", ".py"):
        mod = harness.load_module("metrics", name)
        assert mod.SOURCE in ("device_trace", "program_span", "program_counter",
                              "host_clock")
        assert mod.BETTER in ("lower", "higher")
        assert callable(mod.read)


def test_benchmark_json_matches_the_files():
    assert BENCHMARK["paths"] == ["benchmark"]
    assert BENCHMARK["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    cells = {c["name"]: c for c in BENCHMARK["workloads"]}
    assert set(cells) == set(harness.names("workloads"))
    for name, c in cells.items():
        f = harness.load_json("workloads", name)
        assert {k: f[k] for k in ("config", "traffic", "chips", "why")} == {
            k: c[k] for k in ("config", "traffic", "chips", "why")}
        assert c["chips"] in (1, 4) and 1 <= len(c["why"]) <= 200
    configs = {c["name"]: c for c in BENCHMARK["configs"]}
    assert set(configs) == {c["config"] for c in cells.values()}
    for name, c in configs.items():
        assert c["file"] == f"benchmark/configs/{name}.json"
        f = harness.load_json("configs", name)
        assert c["source"] == f["source"] and c["reduced"] == f["reduced"] == []
        s = counts.summary(f)
        assert f["params"] == s["params"]
        assert f["forward_gflop_per_image"] == round(s["forward_gflop_per_image"], 3)
    layers = {m["name"]: m for m in BENCHMARK["per_layer"]}
    assert sorted(layers) == sorted(
        n for n in harness.names("metrics", ".py")
        if set(harness.load_module("metrics", n).WORKLOADS) & set(cells))
    for name, m in layers.items():
        mod = harness.load_module("metrics", name)
        assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"],
                m["workloads"]) == (mod.UNIT, mod.BETTER, mod.SOURCE, mod.LAYER,
                                    mod.MOVES, list(mod.WORKLOADS))
        assert set(m["workloads"]) <= set(cells)
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    for m in BENCHMARK["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def reports(cell: str):
    """The end-to-end metrics a cell reports."""
    return {n for n, m in E2E.items() if cell in m.get("workloads", [cell])}


def test_every_metric_moves_what_its_cells_report():
    for m in BENCHMARK["per_layer"]:
        assert m["moves"] in E2E and m["moves"] != "setup_s"
        for cell in m["workloads"]:
            assert m["moves"] in reports(cell), (m["name"], cell)
    for cell in (c["name"] for c in BENCHMARK["workloads"]):
        assert "setup_s" in reports(cell) and len(reports(cell)) >= 2
        assert any(cell in m["workloads"] for m in BENCHMARK["per_layer"])


def test_names_and_units():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCHMARK[group]:
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
    for c in BENCHMARK["workloads"]:
        assert NAME.match(c["config"]) and NAME.match(c["traffic"])
    for m in BENCHMARK["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.fixture
def bench_copy(tmp_path, monkeypatch):
    """The benchmark's folder copied, the harness pointed at the copy."""
    dst = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH, dst, ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(harness, "BENCH", dst)
    return dst


def test_new_cell_config_and_metric_are_found_as_new_files(bench_copy):
    before = {p: p.read_bytes() for p in bench_copy.rglob("*") if p.is_file()}
    cfg = json.loads((bench_copy / "configs" / "yolov2-416.json").read_text())
    cfg.update(name="tiny-v2", image_size=[64, 64])
    (bench_copy / "configs" / "tiny-v2.json").write_text(json.dumps(cfg))
    cell = json.loads((bench_copy / "workloads" / "yolov2-416.bulk-b64.json").read_text())
    cell.update(name="tiny-v2.bulk-b2", config="tiny-v2", traffic="bulk-b2")
    cell["mix"].update(batch=2, distinct_batches=2, judged_calls=1,
                       warmup_calls=1, keep_lo=2, keep_hi=8)
    (bench_copy / "workloads" / "tiny-v2.bulk-b2.json").write_text(json.dumps(cell))
    (bench_copy / "metrics" / "images_seen.test.py").write_text(
        'LAYER = "test"\nUNIT = "img"\nSOURCE = "program_counter"\n'
        'BETTER = "higher"\nMOVES = "infer_img_per_s"\n'
        'WORKLOADS = ("tiny-v2.bulk-b2",)\n\n\n'
        'def read(tr):\n    return tr.counters["images"]\n')
    assert "tiny-v2.bulk-b2" in harness.names("workloads")
    assert set(harness.metrics_for("tiny-v2.bulk-b2")) == {"images_seen.test"}
    import time

    from benchmark.run import execute

    c = harness.load_json("workloads", "tiny-v2.bulk-b2")
    result, checks = execute(c, harness.load_json("configs", "tiny-v2"), 5, 0.2,
                             True, "cpu", time.perf_counter(), log=lambda s: None)
    assert result["metrics"]["images_seen.test"]["value"] >= 2
    assert set(checks) == set(c["limits"])
    after = {p: p.read_bytes() for p in before}
    assert after == before  # nothing that was there changed
