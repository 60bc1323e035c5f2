"""Device ms of BatchNorm, leaky ReLU and the cast back in one bulk call:
the sum of its `bn_leaky` spans (models/layers.py::ConvBnLeaky), each
timed by the program's CUDA events, the median over the traced window's
calls.  Silent on the CPU."""
from benchmark import program_spans as ps

LAYER = "conv blocks (models/layers.py)"
UNIT = "ms"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "infer_img_per_s"
WORKLOADS = ("yolov2-416.bulk-b64", "yolov3-416.bulk-b256")


def read(tr):
    return ps.per_call(lambda spans: ps.device_ms(spans, "bn_leaky"))
