"""Minimal stdlib HTTP front door for a serving engine.

Port of ``odc_tpu/serve/httpd.py``.

The transport layer is deliberately tiny (no web framework in the image,
and none needed): one ``ThreadingHTTPServer`` whose handlers feed the
:class:`~odc_tpu_torch.serve.server.BatchingServer` — concurrent HTTP requests
coalesce into device batches exactly like library callers.  This is the
smoke-serving/demo surface; production hosts should embed
``BatchingServer`` in their own RPC stack.

Endpoints::

    GET  /manifest            engine manifest JSON (the artifact contract)
    GET  /stats               batching counters (batches, images, sizes)
    POST /predict?conf=&iou=  body: .npy bytes, uint8 [H,W,3] or [N,H,W,3]
                              -> JSON list of reference-contract annot
                              dicts

Run: ``python -m odc_tpu_torch.serve.httpd --engine m.odce --port 8000``
(``--device cpu`` for an artifact exported on the CPU).
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from odc_tpu_torch.serve.engine import ServingEngine, _annot_of, load_engine
from odc_tpu_torch.serve.server import BatchingServer

__all__ = ["start_http_server", "main"]


def _make_handler(batcher: BatchingServer):
    manifest = batcher.engine.manifest

    class Handler(BaseHTTPRequestHandler):
        # Tests and benches don't want per-request stderr lines.
        def log_message(self, fmt, *args):
            pass

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/manifest":
                self._json(200, manifest)
            elif path == "/stats":
                self._json(200, batcher.stats)
            else:
                self._json(404, {"error": f"no such endpoint {path}"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/predict":
                self._json(404, {"error": f"no such endpoint {url.path}"})
                return
            q = parse_qs(url.query)
            try:
                conf = float(q["conf"][0]) if "conf" in q else None
                iou = float(q["iou"][0]) if "iou" in q else None
            except ValueError as e:
                self._json(400, {"error": f"bad query param: {e}"})
                return
            length = int(self.headers.get("Content-Length", 0))
            try:
                arr = np.load(io.BytesIO(self.rfile.read(length)),
                              allow_pickle=False)
            except Exception as e:
                self._json(400, {"error": f"body is not .npy: {e}"})
                return
            if arr.ndim == 3:
                arr = arr[None]
            h, w = manifest["image_hw"]
            if arr.ndim != 4 or arr.shape[1:] != (h, w, 3) or (
                arr.dtype != np.uint8
            ):
                self._json(400, {
                    "error": f"expected uint8 [N,{h},{w},3] or [{h},{w},3], "
                             f"got {arr.dtype} {arr.shape}"
                })
                return
            # One future per image: requests from concurrent HTTP clients
            # interleave into shared device batches.
            futures = [batcher.submit(img, conf, iou) for img in arr]
            try:
                annots = [
                    _annot_of(manifest, f.result()) for f in futures
                ]
            except Exception as e:
                self._json(500, {"error": str(e)})
                return
            self._json(200, annots)

    return Handler


def start_http_server(
    engine: ServingEngine,
    host: str = "127.0.0.1",
    port: int = 0,
    *,
    max_batch: Optional[int] = None,
    max_delay_ms: float = 5.0,
) -> Tuple[ThreadingHTTPServer, BatchingServer]:
    """Start the batcher + a threaded HTTP server (non-blocking).

    Returns ``(httpd, batcher)``; the bound port is ``httpd.server_port``
    (pass ``port=0`` to let the OS pick — what tests do).  Call
    ``httpd.shutdown(); batcher.stop()`` to tear down.
    """
    batcher = BatchingServer(
        engine, max_batch=max_batch, max_delay_ms=max_delay_ms
    ).start()
    httpd = ThreadingHTTPServer((host, port), _make_handler(batcher))
    threading.Thread(
        target=httpd.serve_forever, name="odc-serve-http", daemon=True
    ).start()
    return httpd, batcher


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="serve an ODCE engine artifact over HTTP"
    )
    p.add_argument("--engine", required=True, help="path to .odce artifact")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=None,
                   help="device batch cap (required for symbolic-batch "
                   "artifacts)")
    p.add_argument("--max-delay-ms", type=float, default=5.0)
    p.add_argument("--device", default="cuda",
                   help="device to run on (the artifact's device type)")
    args = p.parse_args(argv)

    engine = load_engine(args.engine, args.device)
    httpd, batcher = start_http_server(
        engine, args.host, args.port,
        max_batch=args.max_batch, max_delay_ms=args.max_delay_ms,
    )
    print(
        f"serving {engine.manifest['model']} "
        f"({engine.manifest['precision']}) on "
        f"http://{args.host}:{httpd.server_port}  [ctrl-c to stop]"
    )
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        httpd.shutdown()
        batcher.stop()


if __name__ == "__main__":
    main()
