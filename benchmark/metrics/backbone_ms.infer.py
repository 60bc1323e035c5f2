"""Device ms of the backbone in one bulk call: CUDA events at its entry and
exit (Darknet-19's stages 3-7 after the fused stem; all of Darknet-53),
the median over the traced window's calls."""
from benchmark.harness import median

LAYER = "model forward (models/backbones)"
UNIT = "ms"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "infer_img_per_s"
WORKLOADS = ("yolov2-416.bulk-b64", "yolov3-416.bulk-b256")


def read(tr):
    return median(tr.device_ms.get("backbone", []))
