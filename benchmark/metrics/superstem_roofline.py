"""Share of its least time that the fused Darknet-19 stem takes: the
bound of stages 1-2 over every launch of the traced window (uint8 images
in, the pooled bf16 map out, the two convolutions' FLOPs at the bf16
peak; benchmark/counts.py) over the device time of the kernels named
superstem in the profiler's trace.  Silent where no such kernel ran."""
from benchmark import counts

LAYER = "kernels (ops/cuda)"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "higher"
MOVES = "infer_img_per_s"
WORKLOADS = ("yolov2-416.bulk-b64",)


def read(tr):
    sec, n = tr.kernel_s("superstem")
    if not n or not sec:
        return None
    h, w = tr.values["image_hw"]
    return 100.0 * n * counts.superstem_bound_s(tr.counters["batch"], h, w) / sec
