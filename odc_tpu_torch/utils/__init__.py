from odc_tpu_torch.utils.metrics import JsonlLogger, Throughput, profiler_trace

__all__ = ["JsonlLogger", "Throughput", "profiler_trace"]
