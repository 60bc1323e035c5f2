"""Build the native loader: ``python -m odc_tpu_torch.native.build``.

Compiles ``native/src/loader.cc`` with g++ into
``build/native/libodc_loader.so`` of the checkout (the loader also builds
it at first use)."""

from __future__ import annotations

import sys

from odc_tpu_torch.native.loader import LIB_PATH, build

if __name__ == "__main__":
    print(build(LIB_PATH, force=True))
    sys.exit(0)
