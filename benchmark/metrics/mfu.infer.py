"""The whole bulk call's share of the bf16 peak: the configuration's
forward FLOPs an image (benchmark/counts.py) x images completed in the
traced window / its seconds / 989e12."""
from benchmark import counts

LAYER = "model step"
UNIT = "%"
SOURCE = "host_clock"
BETTER = "higher"
MOVES = "infer_img_per_s"
WORKLOADS = ("yolov2-416.bulk-b64", "yolov3-416.bulk-b256")


def read(tr):
    flops = counts.conv_flops_per_image(tr.config) * tr.counters["images"]
    return 100.0 * flops / tr.window_s / counts.BF16_FLOPS
