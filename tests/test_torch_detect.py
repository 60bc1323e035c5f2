"""The port's end-to-end inference (``odc_tpu_torch.ops.detect``) against
``odc_tpu.ops.detect.jit_infer_fn`` on the same bridged weights and images,
on the CPU in f32 — the fused stem running through its plain version — plus
the package's import and device rules."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from odc_tpu.ops.detect import jit_infer_fn
from odc_tpu_torch.ops.cuda.nms_kernel import suppress
from odc_tpu_torch.ops.cuda.superstem_kernel import superstem
from odc_tpu_torch.ops.decode import YOLOV2_ANCHORS
from odc_tpu_torch.ops.detect import make_infer_fn
from torch_port_helpers import calibrated_yolov2, port_model, run_python

# 3x the importing child's 3.1 s in a full tier-1 run (CHANGES.md).
CHILD_LIMIT_S = 9
# The forward tolerance of test_torch_yolov2 / tests/test_e2e_parity.py.
RTOL, ATOL = 1e-3, 2e-3


@pytest.fixture(scope="module")
def shared():
    """(images, JAX infer args, port model, JAX head output, conf_thre)."""
    rng = np.random.default_rng(10)
    images = rng.integers(0, 255, (2, 96, 96, 3), dtype=np.uint8)
    jmodel, variables = calibrated_yolov2(images)
    jv = jax.tree.map(jnp.asarray, variables)
    y = np.asarray(jmodel.apply(jv, jnp.asarray(images), train=False))
    # conf_thre at the midpoint of the largest gap between adjacent sorted
    # candidate confs (ROADMAP Queue 1 item 4): no borderline candidate.
    s = np.sort(1.0 / (1.0 + np.exp(-y[..., 4].astype(np.float64).ravel())))
    s = s[::-1][:40]
    r = int(np.argmax(s[:-1] - s[1:]))
    assert s[r] - s[r + 1] > 1e-3
    conf_thre = float((s[r] + s[r + 1]) / 2)
    return images, (jmodel, jv), port_model(variables), y, conf_thre


@pytest.mark.parametrize(
    "compact,class_wise", [(False, False), (True, False), (False, True)]
)
def test_infer_matches_jit_infer_fn(shared, compact, class_wise):
    """Kept set and order identical; boxes within the forward tolerance
    carried through decode to pixels (d x1 <= cell * (d tx / 4 +
    max anchor * exp(max tw) * d tw / 2), with d t <= ATOL + RTOL |t|)."""
    images, (jmodel, jv), model, y, conf_thre = shared
    kw = dict(conf_thre=conf_thre, iou_thre=0.5, max_keep=64,
              class_wise=class_wise, compact=compact)
    ref = [np.asarray(a) for a in jit_infer_fn(jmodel, **kw)(jv, images)]
    launches = (superstem.launches, suppress.launches)
    got = [t.numpy() for t in make_infer_fn(model, **kw)(torch.tensor(images))]
    assert (superstem.launches, suppress.launches) == launches  # CPU: plain

    keep = ref[-1]
    assert 0 < keep.sum() < keep.size
    np.testing.assert_array_equal(got[-1], keep)
    d_t = ATOL + RTOL * np.abs(y).max()
    cell = 96 / 3
    box_atol = cell * d_t * (0.25 + max(map(max, YOLOV2_ANCHORS))
                             * np.exp(np.abs(y[..., 2:4]).max()) / 2)
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=box_atol)
    # Identical order: each kept slot holds the same candidate, so its
    # conf and class scores agree to the conf noise.
    for r, g in zip(ref[1:-1], got[1:-1]):
        if r.dtype == np.int32:
            np.testing.assert_array_equal(g, r)
        else:
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-4)
    assert got[0].shape == (2, 64, 4)


def test_package_imports_without_jax():
    """Every module of odc_tpu_torch, the int8 slice's included, imports
    with jax, flax and odc_tpu made unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'flax', 'odc_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import odc_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "odc_tpu_torch.__path__, 'odc_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "int8 = {'odc_tpu_torch.ops.quantize', 'odc_tpu_torch.ops.int8_engine',\n"
        "        'odc_tpu_torch.ops.cuda.matmul_kernel'}\n"
        "assert len(names) >= 37 and int8 <= set(names), names\n"
        "print(len(names))\n"
    )
    run_python("-c", code, timeout=CHILD_LIMIT_S)


def test_entry_point_without_device_refuses_cpu():
    """Without ``device``, the model is built for the card; with no card it
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from odc_tpu_torch.models.yolov2 import YOLOv2

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        YOLOv2()
