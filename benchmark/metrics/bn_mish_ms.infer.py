"""Device ms of BatchNorm, Mish and the cast back in one bulk call of a
YOLOv4: the sum of its `bn_mish` spans (models/layers.py::ConvBnLeaky with
activation "mish"; on the fused route the one bias_bn_mish kernel, bias add
included), each timed by the program's CUDA events, the median over the
traced window's calls.  Silent on the CPU and for a program without
Mish blocks."""
from benchmark import program_spans as ps

LAYER = "conv blocks (models/layers.py)"
UNIT = "ms"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "infer_img_per_s"
WORKLOADS = ("yolov4-608.bulk-b64",)


def read(tr):
    return ps.per_call(lambda spans: ps.device_ms(spans, "bn_mish"))
