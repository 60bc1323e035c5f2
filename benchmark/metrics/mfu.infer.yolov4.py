"""The whole bulk call's share of the bf16 peak for a YOLOv4: the forward
FLOPs an image (reference/yolov4.py::conv_flops_per_image) x images
completed in the traced window / its seconds / 989e12."""
from benchmark import counts
from benchmark.reference import yolov4

LAYER = "model step"
UNIT = "%"
SOURCE = "host_clock"
BETTER = "higher"
MOVES = "infer_img_per_s"
WORKLOADS = ("yolov4-608.bulk-b64",)


def read(tr):
    flops = yolov4.conv_flops_per_image(tr.config) * tr.counters["images"]
    return 100.0 * flops / tr.window_s / counts.BF16_FLOPS
