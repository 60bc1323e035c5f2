"""Hand-written CUDA kernels for Hopper (sources in ``odc_tpu_torch/csrc``),
each beside its plain PyTorch version.  Importing the package registers
the kernels as PyTorch operators (``ops.py``)."""

from odc_tpu_torch.ops.cuda import ops  # noqa: F401
