"""Serving: the exported engine artifact (``engine.py``), the micro-batching
server (``server.py``), the HTTP door (``httpd.py``) and the export command
line (``python -m odc_tpu_torch.serve``).  Port of ``odc_tpu/serve/``."""

from odc_tpu_torch.serve.engine import (  # noqa: F401
    ServingEngine,
    export_engine,
    load_engine,
    save_engine,
)
from odc_tpu_torch.serve.server import BatchingServer  # noqa: F401
