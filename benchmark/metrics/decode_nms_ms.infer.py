"""Device ms from the head's output to the end of a bulk call (decode,
the candidate sort and the NMS kernel), CUDA events, the median over the
traced window's calls."""
from benchmark.harness import median

LAYER = "decode and NMS (ops/decode.py, core/nms.py)"
UNIT = "ms"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "infer_img_per_s"
WORKLOADS = ("yolov2-416.bulk-b64", "yolov3-416.bulk-b256")


def read(tr):
    return median(tr.device_ms.get("decode_nms", []))
