"""The mesh's model axis (``odc_tpu_torch/parallel/mesh.py``: ``make_mesh``,
``shard_model``, ``ModelShard``) against the JAX package and against one
process, on the CPU with gloo.

* The sharded set: the parameters ``shard_model`` shards in each model
  (on the workers, and ``model_axis_layers`` of the one-process model) are
  the leaves JAX ``param_specs`` marks ``"model"`` on a JAX init's tree
  (shapes from ``jax.eval_shape``; no device is needed), mapped through
  ``convert_jax``'s names.
* The uneven split and its reassembly (YOLOv1's 1470-wide head over 4
  ranks: 368, 368, 367, 367), in one process.
* Two gloo processes at (data 1, model 2) for YOLOv2, YOLOv1 (dropout 0.5)
  and YOLOv3, and four at (data 2, model 2) for YOLOv2
  (``tests/torch_dp_worker.py``, one launch each, run side by side): one
  float64 train step at 64x64, global batch 4, momentum 0.9, device
  augmentation, each rank starting from other weights.  Against the same
  step in one process from global rank 0's weights (which ``shard_model``
  sends to every rank), run here meanwhile: the loss and its parts within
  1e-9 relative, the update of every parameter within 1e-6 relative l2;
  the ranks' gathered
  states bitwise equal (by CRC-32 digests); global rank 0's checkpoint
  (``checkpoint.save``) loads bit for bit into a one-process model,
  checked in the worker through memory (float64 states of up to 1.1 GB, a
  small disk).  The four ranks then run the training CLI (YOLOv1, dropout
  0.5) with ``--data-parallel 2 --model-parallel 2``, resuming (and so
  sharding) a one-card checkpoint file, and its ``--qat`` on the same mesh
  (YOLOv2, one epoch) from a one-card checkpoint.  Float64, as in
  ``tests/test_torch_parallel.py``: a random network's f32 step is chaotic
  at this size.  (QAT's numbers on the model axis:
  ``tests/test_torch_qat_model_axis.py``.)
"""

import io

import pytest
import torch

import jax
import jax.numpy as jnp

from odc_tpu.models.yolov1 import YOLOv1 as JaxYOLOv1
from odc_tpu.models.yolov2 import YOLOv2 as JaxYOLOv2
from odc_tpu.models.yolov3 import YOLOv3 as JaxYOLOv3
from odc_tpu.parallel.mesh import param_specs
from odc_tpu_torch.config import MeshConfig
from odc_tpu_torch.data import voc as tvoc
from odc_tpu_torch.models.convert_jax import _leaves, _tree_kind
from odc_tpu_torch.parallel import (
    DataParallel, ModelShard, check_mesh, shard_model,
)
from odc_tpu_torch.train import __main__ as cli

import torch_dp_worker
from torch_port_helpers import DP_WORKER, free_port, launch_ranks

NAMES = ("YOLOv2", "YOLOv1", "YOLOv3")
RUNS = [("YOLOv2", 2), ("YOLOv1", 2), ("YOLOv3", 2), ("YOLOv2", 4)]


def _ids(runs):
    return [f"{name}-{'1x2' if world == 2 else '2x2'}" for name, world in runs]
HW = torch_dp_worker.HW


def _jax_model(name):
    if name == "YOLOv1":
        return JaxYOLOv1(num_grid_cell_in_height=2, num_grid_cell_in_width=2,
                         image_size=HW)
    return {"YOLOv2": JaxYOLOv2, "YOLOv3": JaxYOLOv3}[name](image_size=HW)


@pytest.mark.parametrize("name", NAMES)
def test_sharded_set_matches_jax_param_specs(mesh_runs, name):
    """The weights the (1, 2) ranks sharded, and ``model_axis_layers``' of
    the one-process model."""
    shapes = jax.eval_shape(_jax_model(name).init, jax.random.key(0),
                            jnp.zeros((1, *HW, 3), jnp.uint8))
    specs = param_specs(shapes)["params"]
    want = set()
    for path, port_name in _leaves(_tree_kind(shapes["params"]), "params"):
        spec = specs
        for key in path:
            spec = spec[key]
        if "model" in tuple(spec):
            want.add(port_name)
    ranks = mesh_runs["ranks"][2]
    assert want and set(ranks[0][name]["axis_layers"]) == want
    for rank in ranks:
        assert set(rank[name]["sharded"]) == want


def test_uneven_split_reassembles():
    """1470 over 4: ``tensor_split``'s slices, each padded to the largest
    for the all-gather and cut back; the backward keeps each rank's slice
    of the gradient."""
    full = torch.arange(2 * 1470, dtype=torch.float64).view(2, 1470)
    shards = [ModelShard(None, r, 4, 1470) for r in range(4)]
    assert shards[0].sizes == [368, 368, 367, 367]
    assert [s.start for s in shards] == [0, 368, 736, 1103]
    local = [s.local(full, dim=-1) for s in shards]
    padded = [s._padded(t, -1) for s, t in zip(shards, local)]
    assert all(p.shape == (2, 368) for p in padded)
    assert torch.equal(shards[2]._joined(padded, -1), full)
    weight = full.t().contiguous()  # a Linear weight, [out, in]
    parts = [s._padded(s.local(weight), 0) for s in shards]
    assert torch.equal(shards[0]._joined(parts, 0), weight)
    with pytest.raises(ValueError, match="expected 1470 channels"):
        shards[0].local(full[:, :1469], dim=-1)


def test_check_mesh_and_unshardable_layers():
    dp4 = DataParallel(0, 4, torch.device("cpu"))
    assert check_mesh(MeshConfig(-1, 2), dp4) == 2
    assert check_mesh(MeshConfig(2, 2), dp4) == 2
    assert check_mesh(MeshConfig(-1, 1), None) == 1
    with pytest.raises(ValueError, match="differs from the 4 process"):
        check_mesh(MeshConfig(3, 2), dp4)
    with pytest.raises(ValueError, match=r"model parallelism \(3\) is not "):
        check_mesh(MeshConfig(-1, 3), dp4)
    wide = torch.nn.Sequential(torch.nn.Conv2d(3, 512, 1))
    mesh = DataParallel(0, 1, torch.device("cpu"), model_size=2)
    with pytest.raises(ValueError, match="does not run sharded"):
        shard_model(wide, mesh)


def test_qat_accepts_the_model_axis(mesh_runs, capsys):
    """``--qat`` with ``--model-parallel 2`` meets only the mesh's own check
    in one process (the world size), as training does; under the four
    workers the CLI ran ``finetune_qat`` on the (2, 2) mesh: every rank
    printed the same QAT epoch (global metrics) and finished."""
    from odc_tpu_torch.train import qat as tqat

    assert not hasattr(tqat, "check_qat_mesh")
    with pytest.raises(SystemExit) as e:
        cli.main(["--device", "cpu", "--model", "YOLOv2", "--qat", "x.ckpt",
                  "--model-parallel", "2"])
    assert e.value.code == 2
    assert "model parallelism (2) is not supported by the 1 process" in (
        capsys.readouterr().err)
    epochs = [[ln for ln in o.splitlines() if ln.startswith("QAT Epoch")]
              for o in mesh_runs["stderr"]]
    assert len(epochs[0]) == 1 and all(e == epochs[0] for e in epochs)
    assert all("done; QAT checkpoints" in o for o in mesh_runs["stderr"])


# -- gloo processes --------------------------------------------------------


# 3x each group's time in a full tier-1 run, 33.1 and 41.2 s (CHANGES.md).
RANKS_LIMIT_S = {2: 99, 4: 123}


def _launch(world: int, out, data_dir):
    port = qat_port = free_port()
    while qat_port == port:  # the QAT CLI's group, after the first CLI's
        qat_port = free_port()
    return launch_ranks(world, [DP_WORKER, str(out), str(data_dir),
                                "model-axis"],
                        timeout=RANKS_LIMIT_S[world],
                        env={"MASTER_PORT": str(port),
                             "QAT_MASTER_PORT": str(qat_port)})


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Launch the (1, 2) and (2, 2) workers side by side; meanwhile run
    each model's step in one process.  Returns the ranks' results (read
    from their standard output: nothing large goes to the disk), the CLI
    run's, the four ranks' standard errors and the one-process
    references."""
    out = tmp_path_factory.mktemp("mp")
    data_dir = tvoc.make_synthetic_voc(str(out / "voc"), num_train=4,
                                       num_val=4, seed=6)
    with _launch(2, out, data_dir) as small, _launch(4, out, data_dir) as big:
        reference = {name: torch_dp_worker.model_axis_step(name)
                     for name in NAMES}
        outputs = {2: small.wait(), 4: big.wait()}
    ranks = {w: [torch.load(io.BytesIO(stdout), weights_only=False)
                 for stdout, _ in outputs[w]] for w in (2, 4)}
    return dict(ranks=ranks, cli=ranks[4][0]["cli"], qat=ranks[4][0]["qat"],
                reference=reference,
                stderr=[e.decode() for _, e in outputs[4]])


@pytest.mark.parametrize("name, world", RUNS, ids=_ids(RUNS))
def test_loss_matches_one_process(mesh_runs, name, world):
    """Every rank's loss and parts against the same step in one process
    from the same weights."""
    want = mesh_runs["reference"][name]["metrics"]
    for rank in mesh_runs["ranks"][world]:
        got = rank[name]["metrics"]
        assert got.keys() == want.keys()
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-9 * abs(want[k]), (k, got[k],
                                                                  want[k])


@pytest.mark.parametrize("name, world", RUNS, ids=_ids(RUNS))
def test_update_matches_one_process(mesh_runs, name, world):
    """Every parameter's update (the gathered parameters after the step
    less the initial ones, which every rank took) within relative l2 1e-6
    of the one-process update."""
    want = mesh_runs["reference"][name]["update"]
    got = mesh_runs["ranks"][world][0][name]["update"]
    assert got.keys() == want.keys() and len(want) > 50
    for n, w in want.items():
        rel = (got[n] - w).norm() / w.norm().clamp(min=1e-30)
        assert rel <= 1e-6, (n, float(rel))


@pytest.mark.parametrize("name, world", RUNS, ids=_ids(RUNS))
def test_ranks_hold_bitwise_equal_gathered_states(mesh_runs, name, world):
    ranks = [r[name] for r in mesh_runs["ranks"][world]]
    assert len(ranks[0]["digests"]) > 200
    assert all(r["digests"] == ranks[0]["digests"] for r in ranks)
    assert all(r["sharded"] == ranks[0]["sharded"] for r in ranks)


@pytest.mark.parametrize("name, world", RUNS, ids=_ids(RUNS))
def test_checkpoint_loads_bitwise_into_one_process(mesh_runs, name, world):
    """Global rank 0's checkpoint of the gathered state (which the other
    ranks' digests equal), restored into an unsharded model: every
    parameter, statistic and momentum buffer bit for bit, at step 1."""
    rank0 = mesh_runs["ranks"][world][0][name]
    assert rank0["checkpoint_step"] == 1
    assert rank0["checkpoint_differs"] == []


def test_cli_model_parallel_resumes_and_writes_on_rank_zero(mesh_runs):
    """``--data-parallel 2 --model-parallel 2`` under the four workers
    (YOLOv1, dropout 0.5, float32): every rank resumes a one-card
    checkpoint (step 1) and prints the same losses; only global rank 0's
    folder holds files, and its final checkpoint, gathered, loads into a
    one-card YOLOv1."""
    folders = mesh_runs["cli"]["folders"]
    assert len(folders) == 4
    writer = [r for r in folders if " rank" not in r]
    assert len(writer) == 1
    assert folders[writer[0]] == sorted([
        "train_config.json", "metrics.jsonl", "training_result.pkl",
        "best_model.ckpt", "final_model.ckpt"])
    assert all(not files for r, files in folders.items() if r != writer[0])
    outs = mesh_runs["stderr"]  # the workers print to standard error
    assert all("at step 1" in o for o in outs)
    epochs = [[ln for ln in o.splitlines() if ln.startswith("Epoch")]
              for o in outs]
    assert len(epochs[0]) == 1 and all(e == epochs[0] for e in epochs)
    assert mesh_runs["cli"]["final_step"] == 2
    assert mesh_runs["cli"]["final_finite"]


def test_cli_qat_model_parallel_writes_gathered_checkpoints(mesh_runs):
    """``--qat`` under the four workers (``--data-parallel 2
    --model-parallel 2``, from a one-card YOLOv2 checkpoint at step 1):
    only global rank 0's folder holds files, the scales once and the best
    and final checkpoints, gathered: the final one restores into a
    one-card YOLOv2, finite, at step 2."""
    folders = mesh_runs["qat"]["folders"]
    assert len(folders) == 4
    (writer,) = [r for r in folders if " rank" not in r]
    assert folders[writer] == sorted([
        "metrics.jsonl", "int8_scales.npy", "best_qat_model.ckpt",
        "final_qat_model.ckpt"])
    assert all(not files for r, files in folders.items() if r != writer)
    assert mesh_runs["qat"]["final_step"] == 2
    assert mesh_runs["qat"]["final_finite"]
