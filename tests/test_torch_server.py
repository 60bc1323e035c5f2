"""The port's micro-batching server and HTTP door
(``odc_tpu_torch/serve/server.py``, ``httpd.py``) over real loaded
artifacts on the CPU, one test for each of ``tests/test_server.py``'s:
request coalescing, delay flush, FIFO split on an operating-point change,
annots and validation, symbolic-batch buckets, HTTP end to end and
concurrent HTTP clients."""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import torch

from odc_tpu_torch.models import YOLOv2
from odc_tpu_torch.serve import BatchingServer, export_engine, load_engine
from odc_tpu_torch.serve.httpd import start_http_server

HW = (64, 64)


@pytest.fixture(scope="module")
def setup():
    """A fixed-batch (4) and a symbolic-batch artifact of one f32 YOLOv2,
    loaded, and four images."""
    imgs = np.random.default_rng(0).integers(0, 255, (4,) + HW + (3,),
                                             dtype=np.uint8)
    model = YOLOv2(dtype=torch.float32, device="cpu", image_size=HW)
    kw = dict(image_hw=HW, conf_thre=0.0, max_keep=8, device="cpu")
    fixed = load_engine(export_engine(model, batch_size=4, **kw), "cpu")
    sym = load_engine(export_engine(model, batch_size=None, **kw), "cpu")
    return fixed, sym, imgs


def _same(outs, ref, i):
    for got, r in zip(outs, ref):
        np.testing.assert_array_equal(got, r[i])


def test_coalesces_full_batch_and_matches_direct(setup):
    eng, _, imgs = setup
    direct = eng.predict(imgs, conf_thre=0.0)
    with BatchingServer(eng, max_delay_ms=2000) as srv:
        futs = [srv.submit(img, conf_thre=0.0) for img in imgs]
        results = [f.result(timeout=300) for f in futs]
    # all four rode ONE device batch
    assert srv.stats["batch_sizes"] == [4]
    assert srv.stats["images"] == 4 and srv.stats["batches"] == 1
    for i, outs in enumerate(results):
        _same(outs, direct, i)


def test_partial_batch_flushes_on_delay(setup):
    eng, _, imgs = setup
    with BatchingServer(eng, max_delay_ms=20) as srv:
        out = srv.predict_one(imgs[0], conf_thre=0.0)
    assert srv.stats["batch_sizes"] == [1]
    _same(out, eng.predict(imgs[:1], conf_thre=0.0), 0)


def test_op_point_change_splits_batch_fifo(setup):
    """Thresholds are per-batch scalars of the program: a request with
    different (conf, iou) flushes the batch ahead of it, neither sharing it
    nor jumping the queue."""
    eng, _, imgs = setup
    with BatchingServer(eng, max_delay_ms=2000) as srv:
        f_lo = srv.submit(imgs[0], conf_thre=0.0)
        f_hi = srv.submit(imgs[0], conf_thre=0.9)
        f_lo2 = srv.submit(imgs[1], conf_thre=0.0)
        lo, hi, lo2 = (f.result(timeout=300) for f in (f_lo, f_hi, f_lo2))
    assert srv.stats["batch_sizes"] == [1, 1, 1]
    _same(lo, eng.predict(imgs[:1], conf_thre=0.0), 0)
    _same(hi, eng.predict(imgs[:1], conf_thre=0.9), 0)
    _same(lo2, eng.predict(imgs[1:2], conf_thre=0.0), 0)
    assert hi[-1].sum() < lo[-1].sum()


def test_annot_surface_and_validation(setup):
    eng, _, imgs = setup
    with BatchingServer(eng, max_delay_ms=20) as srv:
        annot = srv.predict_annot(imgs[0], conf_thre=0.0)
        assert annot == eng.predict_annots(imgs[:1], conf_thre=0.0)[0]
        assert len(annot["bbox_list"]) == len(annot["lbl_list"]) > 0
        for bad in (np.zeros((32, 32, 3), np.uint8), imgs,
                    imgs[0].astype(np.float32)):
            with pytest.raises(ValueError):
                srv.submit(bad)
    with pytest.raises(RuntimeError):
        srv.submit(imgs[0])  # a stopped server rejects
    with pytest.raises(ValueError):
        BatchingServer(eng, max_batch=8)  # above the compiled batch


def test_symbolic_engine_requires_max_batch_and_buckets_pad(setup):
    """A symbolic-batch artifact needs ``max_batch``; partial batches are
    padded up to the power-of-two ladder, and stats count real images."""
    _, sym, imgs = setup
    with pytest.raises(ValueError):
        BatchingServer(sym)
    seen = []
    forward = sym.forward

    def recording(images, *args):
        seen.append(images.shape[0])
        return forward(images, *args)

    sym.forward = recording
    try:
        with BatchingServer(sym, max_batch=4, max_delay_ms=2000) as srv:
            assert srv._buckets == (1, 2, 4)
            futs = [srv.submit(img, conf_thre=0.0) for img in imgs[:3]]
            results = [f.result(timeout=300) for f in futs]
    finally:
        del sym.forward
    assert srv.stats["batch_sizes"] == [3] and seen == [4]
    padded = np.concatenate([imgs[:3], np.zeros_like(imgs[:1])])
    direct = sym.predict(padded, conf_thre=0.0)
    for i, outs in enumerate(results):
        _same(outs, direct, i)


def _post(url, images):
    buf = io.BytesIO()
    np.save(buf, images)
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def test_http_server_end_to_end(setup):
    eng, _, imgs = setup
    httpd, batcher = start_http_server(eng, port=0, max_delay_ms=20)
    try:
        base = f"http://127.0.0.1:{httpd.server_port}"
        with urllib.request.urlopen(f"{base}/manifest") as r:
            assert json.loads(r.read()) == eng.manifest
        annots = _post(f"{base}/predict?conf=0.0", imgs[:2])
        assert annots == eng.predict_annots(imgs[:2], conf_thre=0.0)
        with urllib.request.urlopen(f"{base}/stats") as r:
            assert json.loads(r.read())["images"] == 2
        # Contract errors come back as HTTP codes with a JSON error.
        for url, body, code in (
                (f"{base}/predict", b"not npy", 400),
                (f"{base}/predict?conf=abc", None, 400),
                (f"{base}/nope", None, 404)):
            if body is None and "predict" in url:
                buf = io.BytesIO()
                np.save(buf, imgs[:1])
                body = buf.getvalue()
            req = urllib.request.Request(
                url, data=body, method="POST" if body else "GET")
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req)
            assert ei.value.code == code
            assert "error" in json.loads(ei.value.read())
        buf = io.BytesIO()
        np.save(buf, imgs[:1].astype(np.float32))
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(urllib.request.Request(
                f"{base}/predict", data=buf.getvalue(), method="POST"))
        assert ei.value.code == 400
    finally:
        httpd.shutdown()
        batcher.stop()


def test_concurrent_http_clients_share_device_batches(setup):
    """Independent single-image HTTP clients coalesce into shared device
    batches, and each gets the engine's own annots."""
    eng, _, imgs = setup
    httpd, batcher = start_http_server(eng, port=0, max_delay_ms=1000)
    try:
        base = f"http://127.0.0.1:{httpd.server_port}"
        results = [None] * 4
        errors = []

        def client(i):
            try:
                results[i] = _post(f"{base}/predict?conf=0.0", imgs[i])
            except Exception as e:  # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads) and not errors
        assert batcher.stats["images"] == 4
        assert len(batcher.stats["batch_sizes"]) < 4
        ref = eng.predict_annots(imgs, conf_thre=0.0)
        for i in range(4):
            assert results[i] == [ref[i]]
    finally:
        httpd.shutdown()
        batcher.stop()
