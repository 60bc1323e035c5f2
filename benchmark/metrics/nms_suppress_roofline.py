"""Share of its least time that greedy suppression takes: the bound for
the candidates each call's NMS received (valid counts read at the call,
benchmark/counts.py) over the device time of the kernels named
nms_suppress in the profiler's trace.  Silent where no such kernel ran."""
from benchmark import counts

LAYER = "kernels (ops/cuda)"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "higher"
MOVES = "infer_img_per_s"
WORKLOADS = ("yolov2-416.bulk-b64", "yolov3-416.bulk-b256")


def read(tr):
    sec, n = tr.kernel_s("nms_suppress")
    valid = tr.values.get("nms_valid")
    if not n or not sec or not valid:
        return None
    return 100.0 * counts.nms_bound_s(valid, int(tr.values["max_keep"])) / sec
