"""Device ms of YOLOv4's spatial pyramid pool in one bulk call: its `spp`
span (models/yolov4.py::SPP, the stride-1 max pools of 13, 9 and 5 and the
2048-channel concat), timed by the program's CUDA events, the median over
the traced window's calls.  Silent on the CPU and for a program without
the span."""
from benchmark import program_spans as ps

LAYER = "neck (models/yolov4.py)"
UNIT = "ms"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "infer_img_per_s"
WORKLOADS = ("yolov4-608.bulk-b64",)


def read(tr):
    return ps.per_call(lambda spans: ps.device_ms(spans, "spp"))
