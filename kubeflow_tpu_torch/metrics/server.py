"""/metrics HTTP endpoint.

The port's own copy of ``kubeflow_tpu/metrics/server.py``: a small
threaded server renders ``Metrics.expose()``, which recomputes the
run-state gauges by listing StatefulSets on every scrape, as the
reference's custom Collector does (pkg/metrics/metrics.go:82-99).
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from kubeflow_tpu_torch.metrics.metrics import Metrics
from kubeflow_tpu_torch.metrics.registry import CONTENT_TYPE


class MetricsServer:
    """Serves one Metrics registry on the metrics address."""

    def __init__(self, metrics: Metrics, host: str = "127.0.0.1", port: int = 0):
        self.metrics = metrics
        registry = self.metrics

        class Handler(BaseHTTPRequestHandler):
            # Avoid Nagle+delayed-ACK ~40ms stalls per request.
            disable_nagle_algorithm = True
            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path.rstrip("/") not in ("/metrics", ""):
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                try:
                    payload = registry.expose()
                    code = 200
                except Exception as err:  # scrape must not kill the server
                    payload = f"# scrape error: {err}\n".encode()
                    code = 500
                self.send_response(code)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def log_message(self, *args):
                pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread:
            self._thread.join(timeout=5)
