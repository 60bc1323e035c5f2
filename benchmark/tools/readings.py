"""The readings a cell's correctness limits are set from, in one process.

    python3 benchmark/tools/readings.py --workload <cell> --seconds <s> \
        --program-seeds 1,2,...  --control-seeds 101,102,103 \
        [--faults nosuppress,half --fault-seeds 201,202,203]

For each program seed: the cell's set-up, a window of ``--seconds`` at the
cell's own load, and the judge (the lower readings).  For each control
seed: the set-up, then the control (the reference in float8 put in the
program's place), judged the same way.  For each named fault
(``tools/faults.py``) and fault seed: the program with the fault planted,
run and judged as a program seed (the upper readings).  One JSON line a
reading on standard output; the kernels are built once for the whole
process.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
import types

ROOT = pathlib.Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--program-seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness
    from benchmark.run import _caches
    from benchmark.tools import faults

    _caches()
    cell = harness.load_json("workloads", args.workload)
    cfg = harness.load_json("configs", cell["config"])
    driver = harness.load_module("drivers", cell["driver"])
    import torch

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    def ctx(seed):
        return types.SimpleNamespace(cell=cell, cfg=cfg, seed=seed,
                                     device=args.device, trace=False,
                                     recorder=harness.Recorder(False),
                                     mark=lambda name: None)

    def emit(kind, seed, numbers, t0):
        print(json.dumps({"cell": cell["name"], "kind": kind, "seed": seed,
                          "seconds": time.perf_counter() - t0, **numbers}),
              flush=True)

    def program(kind, seed):
        t0 = time.perf_counter()
        st = driver.setup(ctx(seed))
        win = driver.window(st, args.seconds, harness.Recorder(False))
        print(*win.get("log", []), sep="\n", file=sys.stderr)
        emit(kind, seed, driver.check(st), t0)
        del st
        if args.device == "cuda":
            torch.cuda.empty_cache()

    for seed in seeds(args.program_seeds):
        program("program", seed)
    for seed in seeds(args.control_seeds):
        t0 = time.perf_counter()
        st = driver.setup(ctx(seed))
        emit("fp8", seed, driver.control(st), t0)
        del st
        if args.device == "cuda":
            torch.cuda.empty_cache()
    for name in [f for f in args.faults.split(",") if f]:
        undo = []

        def patch(obj, attr, value):
            undo.append((obj, attr, getattr(obj, attr)))
            setattr(obj, attr, value)

        faults.plant(name, patch)
        for seed in seeds(args.fault_seeds):
            program(name, seed)
        for obj, attr, value in reversed(undo):
            setattr(obj, attr, value)
    return 0


if __name__ == "__main__":
    sys.exit(main())
