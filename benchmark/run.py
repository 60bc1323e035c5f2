"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, kernel builds from the checkout's cache, weights from the
seed, the reference's BN calibration and threshold, warm-up of the cell's
shapes) is timed as ``setup_s``; then the window runs for ``--seconds``;
then the reference judges what the window produced.  The last line of
standard output is one JSON object (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics from ``torch.profiler``), and the last
lines of standard error are the compared numbers beside their limits.

Exits non-zero, printing no result, without a CUDA device (or with fewer
than the cell asks for), when the program cannot be imported, or when a
JAX module was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _caches() -> None:
    """Every build and kernel cache in fixed folders of the checkout."""
    cache = ROOT / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def execute(cell: dict, cfg: dict, seed: int, seconds: float, trace: bool,
            device: str, t_start: float, log=print):
    """Set up, run the window and judge it on ``device``; returns the result
    object (without the compared numbers) and the compared numbers
    ``{name: (value, limit)}``.  ``log`` takes the lines meant for
    standard error."""
    import torch

    from benchmark import counts, harness

    driver = harness.load_module("drivers", cell["driver"])
    rec = harness.Recorder(trace)
    marks = [("process start", t_start), ("imports", time.perf_counter())]
    ctx = types.SimpleNamespace(
        cell=cell, cfg=cfg, seed=int(seed), device=device, trace=trace,
        recorder=rec, mark=lambda name: marks.append((name, time.perf_counter())))
    cuda = device == "cuda"
    state = driver.setup(ctx)
    if cuda:
        torch.cuda.synchronize()
    # What set-up built lives as long as the run: out of the collector's
    # reach, a full collection in the window no longer walks it.
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    ctx.mark("the rest")
    log("set-up s: " + ", ".join(f"{name} {t - prev:.3f}" for (_, prev), (name, t)
                                 in zip(marks, marks[1:])))
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
        prof.start()
    t0 = time.perf_counter()
    with (torch.profiler.record_function("window") if trace
          else contextlib.nullcontext()):
        win = driver.window(state, seconds, rec)
    window_s = time.perf_counter() - t0
    if prof is not None:
        prof.stop()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    for line in win.get("log", []):
        log(line)
    metrics = {}
    device_info = {"platform": "gpu" if cuda else device,
                   "kind": torch.cuda.get_device_name() if cuda else device,
                   "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        tr = harness.Trace(cell=cell, config=cfg, window_s=window_s,
                           window_t0=t0, recorder=rec)
        tr.values["memory_peak_bytes"] = float(peak)
        harness.reduce_profile(prof, tr)
        del prof
        driver.trace_values(state, tr)
        for name, mod in harness.metrics_for(cell["name"]).items():
            value = mod.read(tr)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": mod.UNIT}
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = window_s
        breakdown = tr.breakdown
    else:
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        for name, (value, unit) in win["metrics"].items():
            metrics[name] = {"value": float(value), "unit": unit}
    power = counts.power_limit() if cuda else None
    log(f"device {device_info['kind']} ({power or 'power limit not read'}), "
        f"setup {setup_s:.3f} s, window {window_s:.3f} s, peak "
        f"{peak / 2**30:.3f} GiB")
    numbers = driver.check(state)
    limits = cell["limits"]
    checks = {k: (float(numbers[k]), float(limits[k])) for k in limits}
    failed = int(win["failed"])
    correct = failed == 0 and all(
        math.isfinite(v) and v <= lim for v, lim in checks.values())
    result = dict(correct=correct, attempted=int(win["attempted"]),
                  failed=failed, metrics=metrics, device=device_info,
                  breakdown=breakdown)
    return result, checks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    _caches()
    from benchmark import harness

    cell = harness.load_json("workloads", args.workload)
    cfg = harness.load_json("configs", cell["config"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"no result: cell {cell['name']} needs {cell['chips']} CUDA "
              f"device(s), this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    def log(line):
        print(line, file=sys.stderr, flush=True)

    result, checks = execute(cell, cfg, args.seed, args.seconds,
                             bool(args.trace), "cuda", T_START, log)
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        print(f"no result: the run loaded {bad}", file=sys.stderr)
        return 3
    for name, (value, limit) in checks.items():
        log(f"check {name} {value!r} limit {limit!r}")
    print(harness.result_line(checks=checks, **result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
