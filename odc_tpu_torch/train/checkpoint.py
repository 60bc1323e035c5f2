"""Checkpoint save/restore.

Port of ``odc_tpu/train/checkpoint.py``: the same file layout
(``best_model.ckpt`` / ``final_model.ckpt``) holding the full train state
(parameters, BN buffers, momentum buffers, step), written with
``torch.save`` as CPU tensors and read back with
``torch.load(weights_only=True)``.

:func:`restore` and :func:`restore_params` also read the JAX package's
checkpoints and params-only files, without flax and
without the ``msgpack`` package: flax's ``to_bytes`` of a ``TrainState``,
msgpack maps whose leaves are ndarrays as ext type 1 (a nested msgpack
``(shape, dtype name, buffer)``), numpy scalars as ext type 3, and arrays
over ``2**30`` bytes split into ``__msgpack_chunked_array__`` dicts.  The
two formats are told apart by their leading bytes: torch's zip archive
begins with ``PK``, a msgpack map with a map tag.
"""

from __future__ import annotations

import struct
from typing import Dict

import numpy as np
import torch

_CHUNKED = "__msgpack_chunked_array__"


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree


def save(path: str, state) -> None:
    """Write ``state.state_dict()`` (a ``TrainState``), or a state dict of
    that layout, to ``path``."""
    sd = state if isinstance(state, dict) else state.state_dict()
    torch.save(_cpu(sd), path)


def _is_msgpack_map(tag: int) -> bool:
    return 0x80 <= tag <= 0x8F or tag in (0xDE, 0xDF)


def restore(path: str, template):
    """Load a checkpoint into ``template`` (e.g. a freshly created
    ``TrainState``), in place, on the template's device.  Returns it.

    ``path`` is a checkpoint of this package or a JAX package ``TrainState``
    of the same model (flax msgpack, carried over through
    ``models/convert_jax.py::train_state_from_jax``); any other file raises
    ``ValueError``."""
    with open(path, "rb") as f:
        head = f.read(2)
    if head == b"PK":
        # Memory-mapped: each tensor is read as it is copied into the
        # template (every rank of a mesh reads the whole file).
        sd = torch.load(path, map_location="cpu", weights_only=True,
                        mmap=True)
    elif head and _is_msgpack_map(head[0]):
        from odc_tpu_torch.models.convert_jax import train_state_from_jax

        sd = train_state_from_jax(read_flax_msgpack(path))
    else:
        raise ValueError(
            f"{path}: neither a checkpoint of this package (a torch zip "
            "archive, 'PK') nor a JAX package checkpoint (a flax msgpack map)"
        )
    template.load_state_dict(sd)
    return template


def save_params(path: str, params: Dict[str, torch.Tensor]) -> None:
    """Params-only checkpoint (deployment artifact): a ``{name: tensor}``
    dict such as ``dict(model.named_parameters())`` or a ``state_dict``."""
    torch.save(_cpu(dict(params)), path)


def restore_params(path: str, template: Dict[str, torch.Tensor]):
    """Read a params-only checkpoint; names and shapes must match
    ``template``, whose devices and dtypes the result takes.

    ``path`` is a file of :func:`save_params` or the JAX package's
    params-only file (``odc_tpu/train/checkpoint.py::save_params``: flax
    msgpack of a YOLOv1, YOLOv2 or YOLOv3 ``params`` tree, which holds no
    BN statistics), read in the port's parameter names
    (``models/convert_jax.py::params_from_jax``); any other file raises
    ``ValueError``."""
    with open(path, "rb") as f:
        head = f.read(2)
    if head == b"PK":
        loaded = torch.load(path, map_location="cpu", weights_only=True)
    elif head and _is_msgpack_map(head[0]):
        from odc_tpu_torch.models.convert_jax import params_from_jax

        loaded = params_from_jax(read_flax_msgpack(path))
    else:
        raise ValueError(
            f"{path}: neither a params file of this package (a torch zip "
            "archive, 'PK') nor one of the JAX package (a flax msgpack map)"
        )
    if sorted(loaded) != sorted(template):
        raise KeyError("checkpoint names differ from the template's")
    out = {}
    for name, ref in template.items():
        if loaded[name].shape != ref.shape:
            raise ValueError(
                f"{name}: checkpoint shape {tuple(loaded[name].shape)} != "
                f"{tuple(ref.shape)}"
            )
        out[name] = loaded[name].to(device=ref.device, dtype=ref.dtype)
    return out


# -- the msgpack subset flax writes ---------------------------------------

# Fixed-width formats: tag -> (kind, struct format of the value or length).
_FORMATS = {
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
    0xCA: ("value", ">f"), 0xCB: ("value", ">d"),
    0xCC: ("value", ">B"), 0xCD: ("value", ">H"), 0xCE: ("value", ">I"),
    0xCF: ("value", ">Q"), 0xD0: ("value", ">b"), 0xD1: ("value", ">h"),
    0xD2: ("value", ">i"), 0xD3: ("value", ">q"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def unpackb(data, ext_hook=None):
    """Decode one msgpack object from ``data`` (bytes-like), as
    ``msgpack.unpackb(data, raw=False)`` does: arrays as lists, str as
    str, bin as bytes, maps as dicts; an ext as ``ext_hook(code, bytes)``,
    or ``(code, bytes)`` without a hook.  Raises ``ValueError`` on
    malformed input or trailing bytes."""
    buf = memoryview(data).cast("B")
    try:
        obj, pos = _unpack(buf, 0, ext_hook)
    except (IndexError, struct.error) as e:
        raise ValueError(f"truncated msgpack data: {e}") from None
    if pos != len(buf):
        raise ValueError(f"{len(buf) - pos} trailing bytes after msgpack data")
    return obj


def _take(buf, pos: int, n: int):
    if pos + n > len(buf):
        raise ValueError("truncated msgpack data")
    return buf[pos:pos + n], pos + n


def _unpack(buf, pos: int, ext_hook):
    tag = buf[pos]
    pos += 1
    if tag <= 0x7F:
        return tag, pos
    if tag >= 0xE0:
        return tag - 0x100, pos
    if tag <= 0x8F:
        return _unpack_map(buf, pos, tag & 0x0F, ext_hook)
    if tag <= 0x9F:
        return _unpack_array(buf, pos, tag & 0x0F, ext_hook)
    if tag <= 0xBF:
        raw, pos = _take(buf, pos, tag & 0x1F)
        return str(raw, "utf-8"), pos
    if tag in (0xC0, 0xC2, 0xC3):
        return {0xC0: None, 0xC2: False, 0xC3: True}[tag], pos
    if tag in _FIXEXT:
        return _unpack_ext(buf, pos, _FIXEXT[tag], ext_hook)
    if tag not in _FORMATS:
        raise ValueError(f"invalid msgpack tag 0x{tag:02x}")
    kind, fmt = _FORMATS[tag]
    (n,) = struct.unpack_from(fmt, buf, pos)
    pos += struct.calcsize(fmt)
    if kind == "value":
        return n, pos
    if kind == "array":
        return _unpack_array(buf, pos, n, ext_hook)
    if kind == "map":
        return _unpack_map(buf, pos, n, ext_hook)
    if kind == "ext":
        return _unpack_ext(buf, pos, n, ext_hook)
    raw, pos = _take(buf, pos, n)
    return (str(raw, "utf-8") if kind == "str" else bytes(raw)), pos


def _unpack_array(buf, pos, n, ext_hook):
    out = []
    for _ in range(n):
        item, pos = _unpack(buf, pos, ext_hook)
        out.append(item)
    return out, pos


def _unpack_map(buf, pos, n, ext_hook):
    out = {}
    for _ in range(n):
        key, pos = _unpack(buf, pos, ext_hook)
        out[key], pos = _unpack(buf, pos, ext_hook)
    return out, pos


def _unpack_ext(buf, pos, n, ext_hook):
    (code,) = struct.unpack_from(">b", buf, pos)
    raw, pos = _take(buf, pos + 1, n)
    raw = bytes(raw)
    return (ext_hook(code, raw) if ext_hook else (code, raw)), pos


def _ndarray(payload: bytes) -> np.ndarray:
    """flax's ndarray payload: msgpack ``(shape, dtype name, buffer)``.
    bfloat16 (no numpy dtype here) becomes float32, exactly."""
    shape, dtype, buffer = unpackb(payload)
    if dtype == "bfloat16":
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, np.dtype(dtype)).reshape(shape)


def _flax_ext(code: int, payload: bytes):
    if code == 1:  # ndarray
        return _ndarray(payload)
    if code == 3:  # numpy scalar
        return _ndarray(payload)[()]
    raise ValueError(f"unknown flax msgpack ext type {code}")


def _unchunk(tree):
    """Reassemble flax's ``__msgpack_chunked_array__`` leaves."""
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED):
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def flax_msgpack_restore(data) -> dict:
    """flax's ``serialization.msgpack_restore``: the state-dict tree of a
    ``to_bytes`` payload, numpy leaves (read-only views of ``data``'s
    copies), chunked arrays reassembled."""
    return _unchunk(unpackb(data, ext_hook=_flax_ext))


def read_flax_msgpack(path: str) -> dict:
    """The state-dict tree of a JAX package checkpoint file (for a
    ``TrainState``: ``params``, ``batch_stats``, ``momentum``, ``step``)."""
    with open(path, "rb") as f:
        return flax_msgpack_restore(f.read())
