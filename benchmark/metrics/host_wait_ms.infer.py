"""Host ms one bulk call waits in blocking host-device transfers: the sum
of its `sync` spans (host clock), the median over the traced window's
calls."""
from benchmark import program_spans as ps

LAYER = "host side of the call (ops/detect.py)"
UNIT = "ms"
SOURCE = "host_clock"
BETTER = "lower"
MOVES = "infer_img_per_s"
WORKLOADS = ("yolov2-416.bulk-b64", "yolov3-416.bulk-b256")


def read(tr):
    return ps.per_call(
        lambda spans: sum(sp.host_ms for sp in ps.named(spans, "sync")))
