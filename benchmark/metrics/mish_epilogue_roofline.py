"""Share of its least time that the Mish blocks' bias + BN + Mish + cast
takes: the bound of one launch a Mish block of each call
(benchmark/epilogue_counts.py, the maps from reference/yolov4.py) over the
device time of the kernels named bias_bn_mish in the profiler's trace,
calls counted as launches over the Mish blocks of one call.  Silent where
no such kernel ran."""
from benchmark import epilogue_counts
from benchmark.reference import yolov4

LAYER = "kernels (ops/cuda)"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "higher"
MOVES = "infer_img_per_s"
WORKLOADS = ("yolov4-608.bulk-b64",)


def read(tr):
    sec, n = tr.kernel_s("bias_bn_mish")
    if not n or not sec:
        return None
    maps = yolov4.mish_maps(tr.config)
    per_call = epilogue_counts.bias_bn_mish_bound_s(tr.counters["batch"], maps)
    return 100.0 * (n / len(maps)) * per_call / sec
