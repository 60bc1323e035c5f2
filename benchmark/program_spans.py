"""The program's own spans of a traced window
(``odc_tpu_torch/utils/metrics.py``), grouped by ``infer`` call, for the
per-layer metrics that read them.  Silent (None) where the program records
no spans: a program without the tracer, a window without a call, or device
times on the CPU."""

from __future__ import annotations

import statistics


def per_call(value):
    """The median over the window's calls of ``value(spans)`` (the spans of
    one call, in the order they started), leaving out calls where it is
    None; None where no call gives a value."""
    try:
        from odc_tpu_torch.utils import metrics
    except ImportError:
        return None
    by_call = getattr(metrics, "spans_by_call", None)
    if by_call is None:
        return None
    vals = [v for v in map(value, by_call().values()) if v is not None]
    return statistics.median(vals) if vals else None


def named(spans, *names):
    return [sp for sp in spans if sp.name in names]


def device_ms(spans, name: str):
    """Summed device ms of the spans named ``name``; None where there are
    none or one has no device time."""
    sel = named(spans, name)
    if not sel or any(sp.device_ms is None for sp in sel):
        return None
    return sum(sp.device_ms for sp in sel)
