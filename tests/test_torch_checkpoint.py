"""The port's checkpoints (``odc_tpu_torch/train/checkpoint.py``) against the
JAX package's: a ``TrainState`` saved by ``odc_tpu.train.checkpoint.save``
(flax msgpack) is read by the port without flax or ``msgpack``, bit for
bit; chunked arrays; the msgpack decoder against ``msgpack.unpackb``; the
port's own checkpoints; foreign files; and ``--resume`` / ``--qat`` of the
command line with a JAX checkpoint."""

import struct

import msgpack
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from flax import serialization

from odc_tpu.train import checkpoint as jckpt
from odc_tpu.train.trainer import TrainState as JTrainState
from odc_tpu_torch.models.convert_jax import jax_from_train_state
from odc_tpu_torch.models.yolov1 import YOLOv1
from odc_tpu_torch.models.yolov2 import YOLOv2
from odc_tpu_torch.train import __main__ as cli
from odc_tpu_torch.train import checkpoint
from odc_tpu_torch.train.trainer import TrainState


def _v1(seed):
    return YOLOv1(num_grid_cell_in_height=2, num_grid_cell_in_width=2,
                  image_size=(64, 64), device="cpu", seed=seed)


_MODELS = {"YOLOv2": lambda seed: YOLOv2(device="cpu", seed=seed),
           "YOLOv1": _v1}


def _state(make, seed=3, step=7):
    """A port train state with random momentum and a non-zero step."""
    state = TrainState(make(seed))
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for buf in state.momentum.values():
            buf.copy_(torch.randn(buf.shape, generator=gen))
        for name, buf in state.model.named_buffers():
            if "running" in name:
                buf.uniform_(0.5, 1.5, generator=gen)
    state.step = step
    return state


def _save_jax(path, state):
    """``state`` as the JAX package's ``TrainState``, saved by its own
    ``checkpoint.save`` (flax ``to_bytes``)."""
    tree = jax_from_train_state(state.state_dict())
    jckpt.save(str(path), JTrainState(
        params=tree["params"], batch_stats=tree["batch_stats"],
        momentum=tree["momentum"], step=jnp.asarray(state.step, jnp.int32)))


def _assert_same(a: TrainState, b: TrainState):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa["step"] == sb["step"]
    for part in ("model", "momentum"):
        assert sorted(sa[part]) == sorted(sb[part])
        for k in sa[part]:
            assert torch.equal(sa[part][k], sb[part][k]), (part, k)


@pytest.fixture
def ckpt_dir(tmp_path):
    """A folder whose checkpoints (up to 0.5 GB each) are removed
    afterwards, passed or failed."""
    yield tmp_path
    for path in tmp_path.rglob("*.ckpt"):
        path.unlink()


@pytest.fixture(scope="module")
def jax_ckpts(tmp_path_factory):
    """``jax_ckpts(name)``: ``(state, path)``, ``_state`` of model ``name``
    and its JAX ``TrainState`` checkpoint, saved once for the module (flax's
    ``to_bytes`` of a full-width YOLOv2 takes seconds); the files are
    removed at the end."""
    folder = tmp_path_factory.mktemp("jax_ckpts")
    cache = {}

    def get(name):
        if name not in cache:
            state = _state(_MODELS[name])
            _save_jax(folder / f"{name}.ckpt", state)
            cache[name] = (state, folder / f"{name}.ckpt")
        return cache[name]

    yield get
    for path in folder.glob("*.ckpt"):
        path.unlink()


@pytest.mark.parametrize("name", ["YOLOv2", "YOLOv1"])
def test_reads_a_jax_train_state_bitwise(name, jax_ckpts):
    """Parameters, BN statistics, momentum and step of a JAX ``TrainState``
    (YOLOv2 at full width, YOLOv1 at 64x64) restore into the port bit for
    bit, with neither flax nor ``msgpack`` on the port's side."""
    state, path = jax_ckpts(name)
    other = checkpoint.restore(str(path), TrainState(_MODELS[name](9)))
    _assert_same(state, other)


def test_reads_chunked_arrays(ckpt_dir, monkeypatch):
    """flax splits arrays over ``MAX_CHUNK_SIZE`` bytes into
    ``__msgpack_chunked_array__`` dicts (2**30 in flax; lowered to 4 KiB
    here so a YOLOv1 state has them): the port reassembles them, and its
    tree equals flax's own ``msgpack_restore`` leaf for leaf, dtypes
    included."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 2 ** 12)
    state = _state(_v1)
    _save_jax(ckpt_dir / "chunked.ckpt", state)
    data = (ckpt_dir / "chunked.ckpt").read_bytes()
    assert b"__msgpack_chunked_array__" in data
    mine = checkpoint.flax_msgpack_restore(data)
    ref = serialization.msgpack_restore(data)
    assert jax.tree.structure(mine) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(ref)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    other = checkpoint.restore(str(ckpt_dir / "chunked.ckpt"),
                               TrainState(_v1(9)))
    _assert_same(state, other)


def test_reads_every_leaf_kind():
    """The ndarray and scalar leaves flax writes: dtypes float32, float16,
    int32, int64, uint8, bool, 0-d arrays, numpy scalars (ext type 3) and
    bfloat16 (read as float32, exactly), against flax's own reader."""
    rng = np.random.default_rng(0)
    tree = {
        "f32": rng.normal(size=(3, 4)).astype(np.float32),
        "f16": rng.normal(size=(5,)).astype(np.float16),
        "i32": np.arange(7, dtype=np.int32) - 3,
        "i64": np.array([2 ** 40, -5], np.int64),
        "u8": rng.integers(0, 255, (2, 2, 3), dtype=np.uint8),
        "bool": np.array([True, False, True]),
        "zero_d": np.asarray(7, np.int32),
        "scalar": np.float32(2.5),
        "nested": {"a": {"b": np.ones((1, 1), np.float32)}},
        "bf16": jnp.asarray([1.5, -2.25, 3e38, 1e-3], jnp.bfloat16),
    }
    data = serialization.to_bytes(tree)
    mine = checkpoint.flax_msgpack_restore(data)
    ref = serialization.msgpack_restore(data)
    assert sorted(mine) == sorted(ref)
    for key in tree:
        a, b = mine[key], ref[key]
        if key == "nested":
            a, b = a["a"]["b"], b["a"]["b"]
        if key == "bf16":
            np.testing.assert_array_equal(a, np.asarray(b, np.float32))
            assert a.dtype == np.float32
            continue
        assert np.asarray(a).dtype == np.asarray(b).dtype, key
        np.testing.assert_array_equal(a, b)
    assert isinstance(mine["scalar"], np.float32) and mine["scalar"] == 2.5


_PAYLOADS = {
    "fixints": [0, 1, 127, -1, -32],
    "uints": [128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1],
    "ints": [-33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1,
             -2 ** 63],
    "floats": [0.0, -1.5, 1e300, float("inf")],
    "nil_bool": [None, True, False],
    "strings": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40000,
                "ünïcode"],
    "bins": [b"", b"x" * 255, b"y" * 256, b"z" * 70000],
    "arrays": [list(range(15)), list(range(16)), list(range(70000)), [[]]],
    "maps": [{str(i): i for i in range(15)}, {str(i): i for i in range(16)},
             {"n": {"m": {"k": [1, {"v": None}]}}}, {}],
    "exts": [msgpack.ExtType(5, b"a"), msgpack.ExtType(1, b"ab"),
             msgpack.ExtType(2, b"abcd"), msgpack.ExtType(3, b"a" * 8),
             msgpack.ExtType(4, b"a" * 16), msgpack.ExtType(6, b"a" * 3),
             msgpack.ExtType(7, b"a" * 300),
             msgpack.ExtType(127, b"a" * 70000), msgpack.ExtType(8, b"")],
}


@pytest.mark.parametrize("name", sorted(_PAYLOADS))
def test_decoder_agrees_with_msgpack(name):
    """Every msgpack format (fixed and sized ints, float 32 and 64, str,
    bin, array and map at each width, fixext and ext 8/16/32), packed by
    ``msgpack``, decodes to what ``msgpack.unpackb`` gives."""
    payload = _PAYLOADS[name]
    data = msgpack.packb(payload, use_bin_type=True)
    ref = msgpack.unpackb(data, raw=False, strict_map_key=False,
                          ext_hook=lambda code, b: (code, b))
    assert checkpoint.unpackb(data) == ref
    f32 = b"\xca" + struct.pack(">f", 1.1)
    assert checkpoint.unpackb(f32) == msgpack.unpackb(f32)


def test_decoder_agrees_with_msgpack_on_a_checkpoint(jax_ckpts):
    """On the bytes of a JAX checkpoint, with flax's ext hook on both."""
    data = jax_ckpts("YOLOv1")[1].read_bytes()
    hook = serialization._msgpack_ext_unpack
    mine = checkpoint.unpackb(data, ext_hook=hook)
    ref = msgpack.unpackb(data, ext_hook=hook, raw=False)
    assert jax.tree.structure(mine) == jax.tree.structure(ref)
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(mine), jax.tree.leaves(ref)))


@pytest.mark.parametrize("data, match", [
    (b"\xc1", "invalid msgpack tag"),
    (b"\x92\x01", "truncated"),
    (b"\xc4\x05ab", "truncated"),
    (b"\x01\x02", "trailing"),
])
def test_decoder_rejects_malformed_input(data, match):
    with pytest.raises(ValueError, match=match):
        checkpoint.unpackb(data)


def test_port_checkpoint_still_restores(ckpt_dir):
    state = _state(_v1)
    checkpoint.save(str(ckpt_dir / "port.ckpt"), state)
    assert (ckpt_dir / "port.ckpt").read_bytes()[:2] == b"PK"
    _assert_same(state, checkpoint.restore(str(ckpt_dir / "port.ckpt"),
                                           TrainState(_v1(9))))


@pytest.mark.parametrize("content", [b"", b"hello", b'{"step": 1}',
                                     b"\x93\x01\x02\x03"])
def test_foreign_file_is_refused(tmp_path, content):
    path = tmp_path / "foreign.ckpt"
    path.write_bytes(content)
    with pytest.raises(ValueError, match="neither"):
        checkpoint.restore(str(path), TrainState(_v1(0)))


@pytest.mark.parametrize("name", ["YOLOv2", "YOLOv1"])
def test_reads_a_jax_params_only_file_bitwise(name, ckpt_dir, jax_ckpts):
    """A params-only file of the JAX package (``save_params``: flax msgpack
    of the ``params`` tree, no BN statistics) restores into the port's
    parameter names bit for bit; a template with other names, or a foreign
    file, is refused."""
    state, _ = jax_ckpts(name)
    named = dict(state.model.named_parameters())
    tree = jax_from_train_state(state.state_dict())
    jckpt.save_params(str(ckpt_dir / "params.ckpt"), tree["params"])
    other = dict(_MODELS[name](9).named_parameters())
    loaded = checkpoint.restore_params(str(ckpt_dir / "params.ckpt"), other)
    assert sorted(loaded) == sorted(named)
    for k, v in named.items():
        assert torch.equal(loaded[k], v), k
    with pytest.raises(KeyError):
        checkpoint.restore_params(str(ckpt_dir / "params.ckpt"),
                                  dict(state.model.state_dict()))
    (ckpt_dir / "foreign.ckpt").write_bytes(b"hello")
    with pytest.raises(ValueError, match="neither"):
        checkpoint.restore_params(str(ckpt_dir / "foreign.ckpt"), other)


@pytest.mark.parametrize("flag", ["--resume", "--qat"])
def test_cli_takes_a_jax_checkpoint(flag, ckpt_dir, jax_ckpts, monkeypatch):
    """``--resume`` and ``--qat`` with a JAX package checkpoint of the
    model: the state the command line hands to training (``Trainer.fit``)
    or to the fine-tune (``finetune_qat``, after a real calibration on the
    train set) is the checkpoint's, bit for bit.  Both stand-ins end the
    run there."""
    from odc_tpu_torch.train import qat as tqat
    from odc_tpu_torch.train import trainer as ttrainer

    state, path = jax_ckpts("YOLOv2")
    seen = {}

    def fake_fit(self, st):
        seen["state"] = st
        return st, {}

    def fake_finetune(model, st, train, val, scales, **kwargs):
        seen["state"], seen["scales"] = st, scales
        seen["momentum"] = kwargs["momentum"]
        return st, {}

    monkeypatch.setattr(ttrainer.Trainer, "fit", fake_fit)
    monkeypatch.setattr(tqat, "finetune_qat", fake_finetune)
    cli.main(["--device", "cpu", "--model", "YOLOv2", "--synthetic",
              "--epochs", "1", "--batch-size", "4", "--image-size", "64",
              flag, str(path),
              "--dataset-dir", str(ckpt_dir / "voc"),
              "--ckpt-root", str(ckpt_dir / "ckpts")])
    _assert_same(state, seen["state"])
    if flag == "--qat":
        assert tuple(seen["scales"].shape) == (22, 2)
        assert seen["momentum"] == 0.9
