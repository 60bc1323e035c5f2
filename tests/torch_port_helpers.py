"""Shared fixtures for the ``tests/test_torch_*.py`` parity tests: one JAX
YOLOv2 init carried into the PyTorch port through the weight bridge, the
port's own seeded YOLOv2 for the int8 tests, and the JAX augmentation's
random draws replayed as the port's parameters; and the one way those tests
start a Python child (:func:`launch_ranks`, :func:`run_python`).  Importing
it caps PyTorch's intra-op threads (below)."""

import collections
import contextlib
import copy
import functools
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np

import jax
import jax.numpy as jnp
import torch

from odc_tpu.models.yolov2 import YOLOv2 as JaxYOLOv2
from odc_tpu.ops import augment as jaug
from odc_tpu_torch.models.convert_jax import (
    jax_from_state_dict, load_jax_yolov2,
)
from odc_tpu_torch.models.layers import TorchBatchNorm
from odc_tpu_torch.models.yolov2 import YOLOv2
from odc_tpu_torch.ops import augment as taug

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DP_WORKER = os.path.join(REPO, "tests", "torch_dp_worker.py")  # one rank

# The tests run under pytest-xdist, several worker processes on one host,
# and PyTorch starts one intra-op thread per core in each, which then
# contend for the cores.  Two threads a worker ran tests/test_torch_*.py in
# 176 s where the default took 237 s (six workers, eight cores).  A child
# process a test starts shares its worker's budget (:class:`Children`).
THREADS = 2
torch.set_num_threads(THREADS)

Output = collections.namedtuple("Output", "stdout stderr")  # bytes each


def free_port() -> int:
    """A TCP port of this host that no socket held when drawn."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Children:
    """Python processes (``python *argv``) started together from the
    repository's root, each in a session of its own, with ``REPO`` on the
    path and ``THREADS // len(argvs)`` intra-op threads (at least one) in
    ``OMP_NUM_THREADS`` and ``MKL_NUM_THREADS``: children that run side by
    side split their worker's budget (no child imports JAX, whose thread
    pool would need a setting of its own).

    :meth:`wait` waits under one limit of ``timeout`` seconds from the
    start; leaving the ``with`` block, passed or failed, kills and reaps
    every child still running."""

    def __init__(self, argvs, timeout: float, envs=None, stdin=None):
        self.argvs, self.timeout = argvs, timeout
        self.start = time.monotonic()
        threads = str(max(1, THREADS // len(argvs)))
        self.procs, self.outputs, self.drainers = [], [None] * len(argvs), []
        try:
            for i, env in enumerate(envs or [{}] * len(argvs)):
                self.procs.append(subprocess.Popen(
                    [sys.executable, *argvs[i]], cwd=REPO,
                    env={**os.environ, "OMP_NUM_THREADS": threads,
                         "MKL_NUM_THREADS": threads,
                         "PYTHONPATH": os.pathsep.join(
                             [REPO, os.environ.get("PYTHONPATH", "")]),
                         **env},
                    stdin=(subprocess.DEVNULL if stdin is None
                           else subprocess.PIPE),
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    start_new_session=True))
                # Pipes drained as they fill: a child that writes much to
                # one never waits for the others to exit.
                self.drainers.append(threading.Thread(
                    target=self._drain, args=(i, stdin), daemon=True))
                self.drainers[-1].start()
        except BaseException:
            self.close()
            raise

    def _drain(self, i: int, stdin) -> None:
        self.outputs[i] = Output(*self.procs[i].communicate(stdin))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self) -> None:
        for proc in self.procs:  # its session: what it started holds pipes
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        for drainer in self.drainers:
            drainer.join()

    def wait(self) -> list:
        """Every child's :data:`Output`, once all exited 0.  Fails with the
        standard error's tail of the first child that exited otherwise, or
        of one still running at the limit; a child's failure does not wait
        for the others (ranks of a group hang in a collective without it)."""
        deadline = self.start + self.timeout
        while (any(p.poll() is None for p in self.procs)
               and not any(p.poll() for p in self.procs)
               and time.monotonic() < deadline):
            time.sleep(0.1)
        failed = [i for i, p in enumerate(self.procs) if p.poll()]
        late = [i for i, p in enumerate(self.procs) if p.poll() is None]
        self.close()
        for i in failed or late:
            argv = " ".join(a[:80] for a in self.argvs[i])
            why = (f"exited {self.procs[i].returncode}" if failed else
                   f"still ran after its {self.timeout} s limit")
            tail = self.outputs[i].stderr.decode(errors="replace")[-3000:]
            raise AssertionError(f"child {i} (python {argv}) {why}:\n{tail}")
        return self.outputs


def launch_ranks(world: int, argv, timeout: float, env=None) -> Children:
    """``world`` ranks of one gloo group, each ``python *argv`` in
    ``torchrun``'s environment (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``
    and ``MASTER_ADDR``/``MASTER_PORT`` on a free port), then ``env``."""
    port = str(free_port())
    envs = [{"RANK": str(r), "LOCAL_RANK": str(r), "WORLD_SIZE": str(world),
             "MASTER_ADDR": "localhost", "MASTER_PORT": port, **(env or {})}
            for r in range(world)]
    return Children([argv] * world, timeout, envs)


def run_python(*argv, timeout: float, stdin: bytes = None) -> Output:
    """``python *argv`` in a child (:class:`Children`), ``stdin`` handed
    over; its :data:`Output` once it exited 0."""
    with Children([argv], timeout, stdin=stdin) as child:
        return child.wait()[0]


@functools.lru_cache(maxsize=1)
def _yolov2_template() -> YOLOv2:
    return YOLOv2(dtype=torch.float32, device="cpu")


def fresh_yolov2() -> YOLOv2:
    """``YOLOv2(dtype=torch.float32, device="cpu")``, the same weights, as a
    copy of one instance built once per process: drawing a full-width
    model's 67 M initial values takes about 1.4 s, a copy 0.2 s."""
    return copy.deepcopy(_yolov2_template())


def port_model(variables) -> YOLOv2:
    """The port's f32 CPU YOLOv2 holding the bridged JAX ``variables``."""
    model = fresh_yolov2()
    load_jax_yolov2(model, variables)
    return model.eval()


def jax_init(jmodel, key: int = 0):
    """``jmodel.init`` at a [1, 64, 64, 3] input, as numpy leaves.  Jitted:
    one compiled program takes a quarter of the time of the eager init,
    op by op, and gives the same leaves bit for bit."""
    v = jax.jit(jmodel.init)(
        jax.random.key(key), jnp.zeros((1, 64, 64, 3), jnp.uint8))
    return jax.tree.map(np.asarray, v)


def calibrated_yolov2(images: np.ndarray):
    """(JAX model, numpy variables) of a random-init f32 YOLOv2 whose BN
    running statistics are set to the batch statistics of ``images``, layer
    by layer, as a trained network's would be.  At the plain random init
    the activations shrink through the 20 layers and every head output sits
    near its bias, so detections would hinge on noise-level differences;
    calibrated, the confidences spread over (0, 1)."""
    jmodel = JaxYOLOv2(dtype=jnp.float32)
    model = port_model(jax_init(jmodel))
    return jmodel, calibrate_bn(model, images)


@functools.lru_cache(maxsize=1)
def int8_parity_setup():
    """(images [2, 64, 96, 3] uint8, JAX model, numpy variables) shared by
    the int8 parity tests of one process: a YOLOv2 from the port's own
    seeded init (no JAX init to compile), BN calibrated on the images."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 255, (2, 64, 96, 3), dtype=np.uint8)
    model = YOLOv2(dtype=torch.float32, device="cpu", seed=0).eval()
    return images, JaxYOLOv2(dtype=jnp.float32), calibrate_bn(model, images)


def pad_to_bucket(images, bucket):
    """Pad native uint8 images top-left with zeros into one bucket batch:
    (uint8 [B, H, W, 3], valid_hw int32 [B, 2])."""
    out = np.zeros((len(images), *bucket, 3), np.uint8)
    vhw = np.zeros((len(images), 2), np.int32)
    for j, img in enumerate(images):
        h, w = img.shape[:2]
        out[j, :h, :w] = img
        vhw[j] = (h, w)
    return out, vhw


def gap_threshold(conf: np.ndarray, lo: int, hi: int) -> float:
    """Midpoint of the largest gap between adjacent sorted confidences
    between ranks ``lo`` and ``hi`` (as ``chip_smoke.py::_gap_threshold``):
    a threshold no candidate sits near, so ulp-level differences cannot
    change which candidates pass it."""
    s = np.sort(conf.ravel().astype(np.float64))[::-1]
    r = lo + int(np.argmax(s[lo:hi] - s[lo + 1:hi + 1]))
    return float((s[r] + s[r + 1]) / 2)


def calibrate_bn(model: YOLOv2, images: np.ndarray):
    """Set every BN's running statistics of the port's ``model`` to the
    batch statistics of ``images`` at its input, layer by layer; returns
    the model's weights as JAX numpy variables."""

    def set_stats(bn, args):
        x = args[0].float().reshape(-1, args[0].shape[-1])
        bn.running_mean.copy_(x.mean(0))
        bn.running_var.copy_(x.var(0))

    hooks = [
        m.register_forward_pre_hook(set_stats)
        for m in model.modules()
        if isinstance(m, TorchBatchNorm)
    ]
    with torch.no_grad():
        model(torch.tensor(images))
    for h in hooks:
        h.remove()
    return jax_from_state_dict(model.state_dict())


def replay_params(key, b, cfg, hw) -> taug.AugmentParams:
    """The parameters ``odc_tpu.ops.augment.augment_batch(key, ...)`` draws
    for a batch of ``b`` (its key splits and ``_color``'s draws, replayed),
    as the port's ``AugmentParams``."""
    keys = jax.random.split(key, b)
    kg, kc = jnp.moveaxis(jax.vmap(jax.random.split)(keys), 1, 0)
    ms = jax.vmap(lambda k: jaug._sample_affine(k, cfg, hw))(kg)

    def color(k):
        ks = jax.random.split(k, 6)
        perm = jax.random.permutation(ks[0], 3)
        do_shuffle = jax.random.uniform(ks[1]) < cfg.p_channel_shuffle
        perm = jnp.where(do_shuffle, perm, jnp.arange(3))
        do_hsv = jax.random.uniform(ks[2]) < cfg.p_hsv
        dh = jax.random.uniform(
            ks[3], minval=-cfg.hue_shift_limit, maxval=cfg.hue_shift_limit)
        ds = jax.random.uniform(
            ks[4], minval=-cfg.sat_shift_limit, maxval=cfg.sat_shift_limit)
        dv = jax.random.uniform(
            ks[5], minval=-cfg.val_shift_limit, maxval=cfg.val_shift_limit)
        return perm, do_hsv, dh, ds, dv

    perm, do_hsv, dh, ds, dv = jax.vmap(color)(kc)
    return taug.AugmentParams(
        ms=torch.tensor(np.asarray(ms, np.float32)),
        perm=torch.tensor(np.asarray(perm, np.int64)),
        do_hsv=torch.tensor(np.asarray(do_hsv)),
        dh=torch.tensor(np.asarray(dh, np.float32)),
        ds=torch.tensor(np.asarray(ds, np.float32)),
        dv=torch.tensor(np.asarray(dv, np.float32)),
    )
