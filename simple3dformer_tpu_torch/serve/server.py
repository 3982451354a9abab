"""Minimal stdlib HTTP model server around serve.Predictor
(port of simple3dformer_tpu/serve/server.py).

POST /predict   {"inputs": [[...voxel grid...], ...]}
                -> {"logits": [...], "topk": [[[label, prob], ...], ...]}
GET  /healthz   -> {"status": "ok", "stats": {...}}

A malformed request gets a 400 with {"error": ...}, a failure of the
model a 500; the server keeps running either way.
"""

from __future__ import annotations

import json
import sys
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .predictor import Predictor, topk_labels


def default_class_names(n_classes: int) -> dict | None:
    """Built-in label maps by head width: ModelNet10/40, S3DIS, ScanObjectNN,
    ImageNet-1k (the JAX package's numpy-only data/classmaps.py)."""
    from simple3dformer_tpu.data import classmaps

    table = {
        10: classmaps.CLASSES_ModelNet10,
        13: classmaps.idx2name(classmaps.S3DIS_NAMES),
        15: classmaps.idx2name(classmaps.SCANOBJECTNN_NAMES),
        40: classmaps.CLASSES_ModelNet40,
    }
    if n_classes == 1000:
        return classmaps.imagenet_class_names()
    return table.get(n_classes)


def make_handler(predictor: Predictor, class_names: dict | str | None = None):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok", "stats": predictor.stats})
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length))
                x = np.asarray(payload["inputs"], dtype=np.float32)
                logits = predictor(x)
            except (ValueError, KeyError, TypeError) as e:  # the request's fault
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
                return
            except Exception as e:  # noqa: BLE001 — the server's fault: report, keep serving
                traceback.print_exc(file=sys.stderr)
                self._send(500, {"error": f"{type(e).__name__}: {e}"})
                return
            names = class_names
            if names == "auto":
                names = default_class_names(logits.shape[-1])
            self._send(200, {
                "logits": logits.tolist(),
                "topk": topk_labels(logits, k=min(5, logits.shape[-1]), names=names),
            })

        def log_message(self, *args):  # quiet
            pass

    return Handler


class ModelServer:
    def __init__(self, predictor: Predictor, host: str = "127.0.0.1",
                 port: int = 0, class_names: dict | str | None = None):
        self.httpd = ThreadingHTTPServer((host, port), make_handler(predictor, class_names))
        self.port = self.httpd.server_address[1]
        self._thread: threading.Thread | None = None

    def start_background(self) -> int:
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()
        return self.port

    def serve_forever(self):
        self.httpd.serve_forever()

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)
