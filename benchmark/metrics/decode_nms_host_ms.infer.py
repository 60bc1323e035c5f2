"""Host ms of one bulk call in decode and NMS, less its waits there: the
`decode` and `nms` spans (ops/detect.py) less the `sync` spans inside them,
host clock, the median over the traced window's calls."""
from benchmark import program_spans as ps

LAYER = "decode and NMS (ops/decode.py, core/nms.py)"
UNIT = "ms"
SOURCE = "host_clock"
BETTER = "lower"
MOVES = "infer_img_per_s"
WORKLOADS = ("yolov2-416.bulk-b64", "yolov3-416.bulk-b256")


def inside(sp, ids, by_id) -> bool:
    """Whether one of ``sp``'s ancestors has its id in ``ids``."""
    parent = sp.parent
    while parent is not None and parent not in ids:
        parent = by_id[parent].parent if parent in by_id else None
    return parent is not None


def tail_ms(spans):
    tail = ps.named(spans, "decode", "nms")
    if not tail:
        return None
    ids = {sp.id for sp in tail}
    by_id = {sp.id: sp for sp in spans}
    waits = [sp for sp in ps.named(spans, "sync") if inside(sp, ids, by_id)]
    return sum(sp.host_ms for sp in tail) - sum(sp.host_ms for sp in waits)


def read(tr):
    return ps.per_call(tail_ms)
