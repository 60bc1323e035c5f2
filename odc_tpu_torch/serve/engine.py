"""Serving engine: the whole inference program as one self-contained artifact.

Port of ``odc_tpu/serve/engine.py``.  :func:`export_engine` captures the
end-to-end program of ``ops/detect.py::make_infer_fn`` (uint8 pixels ->
normalize -> backbone -> decode -> NMS, or the full-int8 PTQ engine with its
calibration baked in) with ``torch.export``, keeps the weights inside it and
returns ONE artifact.  A serving host needs only :func:`load_engine`: no
model code, no checkpoint, no re-trace.  The hand-written kernels appear in
the program as the opaque operators of ``ops/cuda/ops.py``, so the loaded
program launches the same kernels as the direct call.  The confidence and
IoU thresholds stay runtime inputs (0-d float32 CPU tensors), so one
artifact serves every operating point.

Container format (the JAX package's)::

    b"ODCE" | u8 version | u32 LE manifest length | manifest JSON (utf-8)
           | torch.export.save blob

The manifest carries the I/O contract (batch and image shape, max_keep,
class list, output layout, precision) with the JAX package's keys, except
``torch_version`` in place of ``jax_version``; ``platforms`` names the
device type whose tensors the program holds (``["cuda"]`` or ``["cpu"]``).
The program is ``torch.export``'s, not AOTInductor's: Inductor would
recompile the elementwise graph and change its numerics.

This module imports nothing of ``odc_tpu_torch.models`` at load time.
"""

from __future__ import annotations

import copy
import io
import json
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from odc_tpu_torch import resolve_device

_MAGIC = b"ODCE"
_VERSION = 1


def _scalar(x) -> torch.Tensor:
    """A threshold as the program's input: a 0-d float32 CPU tensor, which
    elementwise ops on the card take as a scalar and the NMS operator reads
    on the host, so a call never waits on a device-to-host copy."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).reshape(())
    return torch.tensor(float(x), dtype=torch.float32)


class _Program(torch.nn.Module):
    """``(images uint8 [B, H, W, 3], conf f32 [], iou f32 []) -> outputs``
    of ``infer``; holds ``model`` so that its weights are the program's."""

    def __init__(self, model: torch.nn.Module, infer):
        super().__init__()
        self.model = model
        self._infer = infer

    def forward(self, images, conf_thre, iou_thre):
        return self._infer(images, conf_thre, iou_thre)


def _precision(model, int8_scales) -> str:
    if int8_scales is not None:
        return "int8_full"
    if getattr(model, "int8_dynamic", False):
        return "int8_dynamic"
    return "bf16" if model.dtype == torch.bfloat16 else "f32"


def export_engine(
    model,
    *,
    batch_size: Optional[int],
    image_hw: Tuple[int, int],
    conf_thre: float = 0.9,
    iou_thre: float = 0.5,
    max_keep: int = 64,
    class_wise: bool = False,
    compact: bool = False,
    int8_scales=None,
    int8_stem: str = "s2d",
    cls_list: Optional[Sequence[str]] = None,
    device=None,
    weights_dtype: Optional[torch.dtype] = None,
) -> bytes:
    """Capture and serialize an inference engine; returns the artifact bytes.

    The program's signature is ``(images [B, H, W, 3] uint8, conf_thre f32
    [], iou_thre f32 [])``; it returns the :func:`make_infer_fn` outputs
    (``compact=False``: boxes, conf, cls_scores, keep; ``compact=True``:
    boxes, conf, label, label_score, keep).  ``batch_size=None`` exports a
    symbolic batch (``torch.export.Dim``): one artifact serves every batch
    size.  ``device`` (default: the model's) is where the program's tensors
    live and where it runs.  ``weights_dtype`` (e.g. ``torch.bfloat16``)
    casts the floating weights baked into the artifact, halving it; the bf16
    compute path casts them anyway, so only the BN and fold constants lose
    precision.  ``device`` or ``weights_dtype`` work on a copy of the model.

    ``int8_scales`` (YOLOv2 only) bakes the full int8 PTQ engine with the
    ``int8_stem`` formulation; a YOLOv3 built with ``int8_dynamic`` serves
    its dynamic int8 convs.  ``cls_list`` defaults to VOC's 20 classes."""
    from odc_tpu_torch.ops.detect import make_infer_fn

    if int8_scales is not None and type(model).__name__ != "YOLOv2":
        # A bf16 program under an int8_full manifest would mislabel every
        # measurement taken with it.
        raise ValueError("int8_scales is YOLOv2-only")
    if cls_list is None:
        from odc_tpu_torch.data.voc import CLASS_LIST as cls_list
    dev = (next(model.parameters()).device if device is None
           else resolve_device(device))
    if weights_dtype is not None or dev != next(model.parameters()).device:
        model = copy.deepcopy(model).to(device=dev, dtype=weights_dtype)
    infer = make_infer_fn(
        model, conf_thre, iou_thre, max_keep, class_wise=class_wise,
        compact=compact, int8_scales=int8_scales, int8_stem=int8_stem,
    )
    h, w = image_hw
    # A symbolic batch is traced at 2: an example of 1 would specialize it.
    example = torch.zeros((batch_size or 2, h, w, 3), dtype=torch.uint8,
                          device=dev)
    dynamic = (None if batch_size is not None
               else ({0: torch.export.Dim("b", min=1)}, None, None))
    program = torch.export.export(
        _Program(model, infer),
        (example, _scalar(conf_thre), _scalar(iou_thre)),
        dynamic_shapes=dynamic,
    )
    # The zero images of the trace would travel in the blob otherwise (33 MB
    # at batch 64 and 416x416).
    program.example_inputs = None
    blob = io.BytesIO()
    torch.export.save(program, blob)

    manifest = {
        "format_version": _VERSION,
        "model": type(model).__name__,
        "batch_size": int(batch_size) if batch_size is not None else None,
        "image_hw": [int(h), int(w)],
        "max_keep": int(max_keep),
        "cls_list": list(cls_list),
        "conf_thre_default": float(conf_thre),
        "iou_thre_default": float(iou_thre),
        "class_wise": bool(class_wise),
        "compact": bool(compact),
        "precision": _precision(model, int8_scales),
        "int8_stem": int8_stem if int8_scales is not None else None,
        "platforms": [dev.type],
        "weights_dtype": (str(weights_dtype).removeprefix("torch.")
                          if weights_dtype is not None else "checkpoint"),
        "torch_version": torch.__version__,
        "outputs": (
            ["boxes", "conf", "label", "label_score", "keep"]
            if compact
            else ["boxes", "conf", "cls_scores", "keep"]
        ),
    }
    mbytes = json.dumps(manifest).encode("utf-8")
    return b"".join([_MAGIC, struct.pack("<B", _VERSION),
                     struct.pack("<I", len(mbytes)), mbytes,
                     blob.getvalue()])


def save_engine(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)


def _split(data: bytes) -> Tuple[Dict, bytes]:
    if data[:4] != _MAGIC:
        raise ValueError("not an ODCE engine artifact (bad magic)")
    version = data[4]
    if version > _VERSION:
        raise ValueError(f"engine format v{version} is newer than supported "
                         f"v{_VERSION}")
    (mlen,) = struct.unpack("<I", data[5:9])
    manifest = json.loads(data[9 : 9 + mlen].decode("utf-8"))
    return manifest, data[9 + mlen :]


def _annot_of(manifest: Dict, outs: Tuple[np.ndarray, ...]) -> Dict:
    """One image's engine outputs -> the reference ``detect()`` annot dict
    (``bbox_list``, ``lbl_list``, ``conf_score_list``,
    ``cls_spec_conf_score_list``)."""
    cls_list = manifest["cls_list"]
    if manifest["compact"]:
        boxes, conf, label, label_score, keep = outs
    else:
        boxes, conf, cls_scores, keep = outs
        label = np.argmax(cls_scores, axis=-1)
        label_score = np.take_along_axis(
            cls_scores, label[..., None], axis=-1
        )[..., 0]
    k = np.asarray(keep).astype(bool)
    return {
        "bbox_list": np.asarray(boxes)[k].tolist(),
        "lbl_list": [cls_list[j] for j in np.asarray(label)[k]],
        "conf_score_list": np.asarray(conf)[k].tolist(),
        "cls_spec_conf_score_list": np.asarray(label_score)[k].tolist(),
    }


class ServingEngine:
    """A loaded engine: the validated input contract and numpy in and out.

    ``predict`` accepts any leading batch 1..B (padded with zero images up
    to a fixed compiled batch, outputs trimmed back).  ``predict_annots``
    renders the reference ``detect()`` output contract.  ``forward`` runs
    the program on tensors already on the engine's device."""

    def __init__(self, manifest: Dict, program, device: torch.device) -> None:
        self.manifest = manifest
        self.program = program  # the torch.export.ExportedProgram
        self.device = device
        self._module = program.module()

    @property
    def batch_size(self) -> Optional[int]:
        """Compiled batch, or ``None`` for a symbolic-batch artifact."""
        return self.manifest["batch_size"]

    def forward(self, images: torch.Tensor, conf_thre=None,
                iou_thre=None) -> Tuple[torch.Tensor, ...]:
        """The program on uint8 ``images`` on the engine's device; the
        thresholds default to the manifest's."""
        m = self.manifest
        conf = m["conf_thre_default"] if conf_thre is None else conf_thre
        iou = m["iou_thre_default"] if iou_thre is None else iou_thre
        with torch.no_grad():
            return tuple(self._module(images, _scalar(conf), _scalar(iou)))

    def predict(
        self,
        images: np.ndarray,
        conf_thre: Optional[float] = None,
        iou_thre: Optional[float] = None,
    ) -> Tuple[np.ndarray, ...]:
        images = np.asarray(images)
        b = self.batch_size
        h, w = self.manifest["image_hw"]
        if (images.ndim != 4 or images.shape[1:] != (h, w, 3)
                or images.dtype != np.uint8 or images.shape[0] < 1):
            raise ValueError(
                f"engine expects [n{f'<={b}' if b else ''}, {h}, {w}, 3] "
                f"uint8 with n >= 1, got {images.dtype} {images.shape}"
            )
        n = images.shape[0]
        if b is not None:
            if n > b:
                raise ValueError(f"batch {n} exceeds compiled batch {b}")
            if n < b:
                images = np.concatenate(
                    [images, np.zeros((b - n, h, w, 3), np.uint8)], 0
                )
        x = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        out = self.forward(x, conf_thre, iou_thre)
        return tuple(o[:n].cpu().numpy() for o in out)

    def predict_annots(
        self,
        images: np.ndarray,
        conf_thre: Optional[float] = None,
        iou_thre: Optional[float] = None,
    ) -> List[Dict]:
        outs = self.predict(images, conf_thre, iou_thre)
        return [_annot_of(self.manifest, tuple(o[i] for o in outs))
                for i in range(outs[0].shape[0])]


def load_engine(path_or_bytes, device="cuda") -> ServingEngine:
    """Load an artifact from a path or raw bytes to run on ``device``.

    Registers the kernels' operators and imports no model code.  Raises
    ``ValueError`` for an artifact of the JAX package or one whose tensors
    live on another device type than ``device``'s; raises ``RuntimeError``
    (``resolve_device``) when CUDA is asked for and absent."""
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    manifest, blob = _split(data)
    if "jax_version" in manifest:
        raise ValueError(
            "a JAX package artifact (jax.export StableHLO, jax "
            f"{manifest['jax_version']}): load it with "
            "odc_tpu.serve.load_engine")
    if torch.device(device).type not in manifest["platforms"]:
        raise ValueError(
            f"the artifact's program holds {manifest['platforms']} tensors "
            f"and cannot run on {device!r}: export it on that device")
    dev = resolve_device(device)
    import odc_tpu_torch.ops.cuda  # noqa: F401  (registers the operators)

    return ServingEngine(manifest, torch.export.load(io.BytesIO(blob)), dev)
