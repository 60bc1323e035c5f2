"""odc_tpu_torch — the PyTorch/CUDA port of ``odc_tpu`` for NVIDIA Hopper.

Module names follow the JAX package (``core/nms.py`` here is the counterpart
of ``odc_tpu/core/nms.py``), public layouts too: NHWC uint8 images in,
``[N, Hg, Wg, A, 5 + C]`` head out, ``[B, max_keep, ...]`` NMS outputs.  The
package imports ``torch`` only — never ``jax``, ``flax`` or ``odc_tpu``.

Each Pallas kernel of the JAX package on a ported path is a hand-written
CUDA kernel here (``csrc/``), built with ``nvcc`` at first use
(``ops/cuda/build.py``) and kept beside a plain PyTorch version of the same
function.  A wrapper runs the plain version for CPU tensors and the kernel
for CUDA tensors; it never falls back from one to the other.

Ported so far: YOLOv2 inference (``ops/detect.py::make_infer_fn``), bf16
and int8 PTQ (``ops/int8_engine.py``); YOLOv2 training with in-step device
augmentation (``train/``, ``python -m odc_tpu_torch.train``), with the data
path, the loss and the checkpoints it needs; native-size evaluation and VOC
mAP (``ops/detect.py::make_native_infer_fn``, ``eval/``, ``core/ap.py``)
and the trainer's mAP hook; YOLOv1 (GoogLeNet, ``models/yolov1.py``) for
inference, evaluation and training; YOLOv3 (Darknet-53 and the FPN,
``models/yolov3.py``) for inference in bf16 and with ``int8_dynamic``,
evaluation and training (``losses/yolov3_loss.py``); quantization-aware
fine-tuning of YOLOv2 against the int8 engine (``ops/qat.py``,
``train/qat.py``, ``--qat``), the reader of the JAX package's
checkpoints (``train/checkpoint.py``), and serving: the exported engine
artifact, the micro-batching server, the HTTP door and the export command
line (``serve/``, ``python -m odc_tpu_torch.serve``), with the kernels as
PyTorch operators (``ops/cuda/ops.py``); the C++ JPEG loader, host
augmentation and data parallelism (``native/``, ``data/``,
``parallel/``); the mesh's model axis (``parallel/mesh.py::shard_model``,
``--model-parallel``), remat on YOLOv2 and Darknet-19, YOLOv3's prefix
probes (``stop_after``), the reference-layout torch checkpoint loaders
(``models/convert_torch.py``) and ``utils.Throughput`` /
``utils.profiler_trace``.

Entry points (model constructors, the training command line) default to
``device="cuda"`` and raise when no card is present; the CPU runs only when
the caller asks for it.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if CUDA is asked for and
    absent (the port never moves to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev
