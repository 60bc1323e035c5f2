"""The port's ``utils/metrics.py`` (``Throughput``, ``profiler_trace``) and
``config.DEVICE`` against the JAX package's interface, on the CPU."""

import inspect
import json
import time

import pytest
import torch

from odc_tpu import config as jconfig
from odc_tpu.utils import metrics as jmetrics
from odc_tpu_torch import config as tconfig
from odc_tpu_torch import utils as tutils
from odc_tpu_torch.utils import metrics as tmetrics


def _public(cls):
    return {n for n, _ in inspect.getmembers(cls) if not n.startswith("_")}


def test_throughput_keeps_the_jax_interface():
    assert _public(tmetrics.Throughput) == _public(jmetrics.Throughput)
    assert tutils.Throughput is tmetrics.Throughput
    assert tutils.profiler_trace is tmetrics.profiler_trace
    assert set(tutils.__all__) >= {"JsonlLogger", "Throughput"}


def test_throughput_excludes_the_warmup():
    meter = tmetrics.Throughput()
    meter.start()
    meter.update(999)  # warm-up work, dropped by the next start()
    time.sleep(0.02)
    meter.start()
    meter.update(10)
    meter.update(6)
    time.sleep(0.05)
    rate = meter.images_per_sec
    assert 0 < rate <= 16 / 0.05
    meter.reset()
    with pytest.raises(TypeError):  # as the JAX meter: start() first
        meter.images_per_sec


def test_profiler_trace_is_a_no_op_without_a_folder(tmp_path):
    with tmetrics.profiler_trace(None) as ctx:
        assert ctx is None
        torch.ones(4).sum()
    assert not list(tmp_path.iterdir())


def test_profiler_trace_writes_a_trace_on_the_cpu(tmp_path):
    log_dir = tmp_path / "trace"
    with tmetrics.profiler_trace(str(log_dir)):
        torch.nn.functional.conv2d(torch.ones(1, 3, 8, 8),
                                   torch.ones(4, 3, 3, 3))
    (trace,) = log_dir.iterdir()
    assert trace.suffix == ".json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("conv" in str(e.get("name", "")) for e in events)


def test_device_is_the_default_mesh():
    assert tconfig.DEVICE == tconfig.MeshConfig()
    assert (tconfig.DEVICE.data, tconfig.DEVICE.model) == (
        jconfig.DEVICE.data, jconfig.DEVICE.model)
