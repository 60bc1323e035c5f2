#!/usr/bin/env python3
"""Time the port's affine-warp and NMS-suppression kernels beside the same
kernels built from another checkout, on one card, on the same inputs.

    python3 kernel_ab.py --other DIR [--rounds 2]

DIR holds another checkout of the repository (for example a parent commit
unpacked with ``git archive``).  The script builds ``csrc/warp_affine.cu``
and ``csrc/nms_suppress.cu`` of both trees with ``nvcc`` (the flags of
``odc_tpu_torch/ops/cuda/build.py``), loads each library with ctypes, and
times every kernel in a CUDA graph in turns (this, other, other, this, ...)
at the shapes of ``chip_smoke.py``: the warp on a sampled augmentation batch
of 32 at 416x416x3 (f32, and uint8 where the kernel takes it), the
suppression at B=64, K=64 on the main path's candidates, with nothing valid
and with every box kept.  Each pair of results is checked for equality
first.  Prints the card's name and power limit, one line per measurement
and one JSON object as its last line.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
import tempfile

import torch

import chip_smoke as cs
from odc_tpu_torch.ops.cuda import build

_P, _I = ctypes.c_void_p, ctypes.c_int


def _load(tree: pathlib.Path, out: pathlib.Path, tag: str) -> dict:
    """Build and load both kernels of checkout ``tree``; returns
    {name: (library, takes_uint8)}."""
    procs, libs = {}, {}
    for name in ("warp_affine", "nms_suppress"):
        src = tree / "odc_tpu_torch" / "csrc" / f"{name}.cu"
        so = out / f"lib{name}_{tag}.so"
        cmd = [build.nvcc_path(), *build._BASE_FLAGS, *build.SOURCES[name][1],
               "-o", str(so), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so, src)
    for name, (proc, so, src) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        lib = ctypes.CDLL(str(so))
        takes_u8 = "is_uint8" in src.read_text()
        if name == "warp_affine":
            lib.warp_affine.argtypes = (
                [_P, _P, _P] + [_I] * (7 if takes_u8 else 6) + [_P])
        else:
            lib.nms_suppress.argtypes = [_P, _P, _P, _I, _I, ctypes.c_float, _P]
        libs[name] = (lib, takes_u8)
    return libs


def _warp_call(lib, takes_u8, images, m_invs, out, kmax):
    b, h, w, c = images.shape
    args = [images.data_ptr(), m_invs.data_ptr(), out.data_ptr(), b, h, w, c,
            kmax, kmax]
    if takes_u8:
        args.append(int(images.dtype == torch.uint8))

    def run():
        build.check(lib.warp_affine(
            *args, torch.cuda.current_stream().cuda_stream), "warp_affine")
    return run


def _nms_call(lib, boxes, valid, keep):
    b, k = valid.shape

    def run():
        build.check(lib.nms_suppress(
            boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), b, k, 0.5,
            torch.cuda.current_stream().cuda_stream), "nms_suppress")
    return run


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", required=True, type=pathlib.Path)
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    from odc_tpu_torch.core.nms import sorted_candidates
    from odc_tpu_torch.ops.augment import (
        AugmentConfig, sample_augment_params, warp_max_shear,
    )
    from odc_tpu_torch.ops.warp import shift_kmax

    print(cs.gpu_line())
    here = pathlib.Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR.parent) as tmp:
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        trees = {"this": _load(here, pathlib.Path(tmp), "this"),
                 "other": _load(args.other.resolve(), pathlib.Path(tmp),
                                "other")}

        cfg = AugmentConfig()
        kmax = shift_kmax(cs.HW[0], warp_max_shear(cfg))
        gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 6)
        params = sample_augment_params(gen, cs.TRAIN_BATCH, cfg, cs.HW, "cuda")
        m_invs = torch.linalg.inv(params.ms.double().cpu()).float()
        m_invs = m_invs.contiguous().cuda()
        images_u8 = torch.randint(
            0, 256, (cs.TRAIN_BATCH, *cs.HW, 3), dtype=torch.uint8,
            generator=torch.Generator().manual_seed(cs.SEED + 5)).cuda()
        images = images_u8.float()

        cgen = torch.Generator().manual_seed(cs.SEED + 1)
        boxes, conf = cs._candidates(cgen, cs.BATCH, cs.N_CAND)
        _, cand, surv = sorted_candidates(
            boxes.cuda(), conf.cuda(), conf.cuda() >= 0.5, cs.MAX_KEEP)
        b, k = surv.shape
        step = torch.arange(k, dtype=torch.float32, device="cuda") * 20.0
        disjoint = torch.stack([step, step, step + 10, step + 10], -1)
        disjoint = disjoint.expand(b, k, 4).contiguous()
        cases = {
            "nms main inputs": (cand, surv),
            "nms nothing valid": (cand, torch.zeros_like(surv)),
            "nms all kept": (disjoint, torch.ones_like(surv)),
        }

        calls = {}
        for tag, libs in trees.items():
            wlib, takes_u8 = libs["warp_affine"]
            out = torch.empty(images.shape, dtype=torch.float32, device="cuda")
            calls[("warp f32", tag)] = (
                _warp_call(wlib, takes_u8, images, m_invs, out, kmax), out)
            if takes_u8:
                out8 = torch.empty_like(out)
                calls[("warp uint8", tag)] = (_warp_call(
                    wlib, takes_u8, images_u8, m_invs, out8, kmax), out8)
            nlib = libs["nms_suppress"][0]
            for name, (bx, vd) in cases.items():
                keep = torch.empty((b, k), dtype=torch.bool, device="cuda")
                calls[(name, tag)] = (_nms_call(nlib, bx, vd, keep), keep)

        names = sorted({name for name, _ in calls})
        results = {}
        for name in names:
            tags = [tag for tag in ("this", "other") if (name, tag) in calls]
            for tag in tags:
                calls[(name, tag)][0]()
            cs.sync()
            if len(tags) == 2:
                a, o = calls[(name, "this")][1], calls[(name, "other")][1]
                err = float((a.float() - o.float()).abs().max())
                if name.startswith("nms") and err != 0.0:
                    raise AssertionError(f"{name}: keep masks differ")
                if err > 1e-3:
                    raise AssertionError(f"{name}: outputs differ by {err}")
            times = {tag: [] for tag in tags}
            for _ in range(args.rounds):
                for tag in tags + tags[::-1]:
                    times[tag].append(cs.graph_ms(calls[(name, tag)][0], 50))
            results[name] = {tag: min(v) for tag, v in times.items()}
            print(f"{name}: " + ", ".join(
                f"{tag} {min(v):.4f} ms (runs {[round(x, 4) for x in v]})"
                for tag, v in times.items()))
    print(json.dumps({"kernel_ab": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
