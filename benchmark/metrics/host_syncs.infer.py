"""Blocking host-device transfers in one bulk call: the number of its
`sync` spans, the median over the traced window's calls."""
from benchmark import program_spans as ps

LAYER = "host side of the call (ops/detect.py)"
UNIT = "syncs"
SOURCE = "program_counter"
BETTER = "lower"
MOVES = "infer_img_per_s"
WORKLOADS = ("yolov2-416.bulk-b64", "yolov3-416.bulk-b256")


def read(tr):
    return ps.per_call(lambda spans: len(ps.named(spans, "sync")))
