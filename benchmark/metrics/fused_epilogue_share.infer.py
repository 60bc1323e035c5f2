"""Share of the conv blocks whose bias, BN, leaky and cast ran as the one
fused kernel in one bulk call: its `fused_epilogue` counts over its
`bn_leaky` spans (models/layers.py::ConvBnLeaky), the median over the
traced window's calls.  Silent where the program has no fused epilogue."""
import importlib.util

from benchmark import program_spans as ps

LAYER = "conv blocks (models/layers.py)"
UNIT = "share"
SOURCE = "program_counter"
BETTER = "higher"
MOVES = "infer_img_per_s"
WORKLOADS = ("yolov2-416.bulk-b64", "yolov3-416.bulk-b256")


def _share(spans):
    blocks = ps.named(spans, "bn_leaky")
    if not blocks:
        return None
    fused = sum((sp.counts or {}).get("fused_epilogue", 0) for sp in blocks)
    return fused / len(blocks)


def read(tr):
    if importlib.util.find_spec(
            "odc_tpu_torch.ops.cuda.bias_bn_leaky_kernel") is None:
        return None
    return ps.per_call(_share)
