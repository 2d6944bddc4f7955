"""healthz / readyz probe endpoints.

The port's own copy of ``kubeflow_tpu/k8s/health.py``.

Reference parity: both managers wire named checks into controller-runtime's
healthz server (reference components/notebook-controller/main.go:125-133
``AddHealthzCheck("healthz", healthz.Ping)`` / ``AddReadyzCheck``; ODH
main.go registers the same pair). ``HealthChecks`` is the registry;
``HealthServer`` optionally serves it over real HTTP (the probe-addr flag)
for e2e runs.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional


def ping() -> None:
    """healthz.Ping analog: always healthy."""


class ServeWatchdog:
    """Readyz check that the serve loop is actually draining.

    ``manager.reconcile_errors`` catches reconcilers that run and fail;
    what it can NOT catch is a drain loop that stopped running at all — a
    reconcile blocked forever in a hung client call, a deadlocked watch
    stream, a loop crashed outside the per-cycle try. The serve loop calls
    ``beat(manager.cursor)`` after every successful cycle; readyz turns
    unready once no beat has landed within ``window_s``, so Kubernetes
    restarts a wedged controller instead of routing to a zombie.
    """

    def __init__(
        self,
        window_s: float = 60.0,
        clock: Optional[Callable[[], float]] = None,
    ):
        self.window_s = window_s
        # Monotonic by default: a wall-clock step (NTP, suspend) must not
        # fake a stall or mask a real one.
        self._clock = clock or time.monotonic
        self._last_beat: Optional[float] = None
        self.last_cursor: Optional[int] = None

    def beat(self, cursor: int) -> None:
        """Record one completed drain cycle (cursor = manager.cursor)."""
        self.last_cursor = cursor
        self._last_beat = self._clock()

    def check(self) -> None:
        if self._last_beat is None:
            raise RuntimeError("serve loop has not completed a cycle yet")
        age = self._clock() - self._last_beat
        if age > self.window_s:
            raise RuntimeError(
                f"serve loop stalled: no heartbeat for {age:.0f}s "
                f"(window {self.window_s:.0f}s, last cursor "
                f"{self.last_cursor})"
            )

    def register(self, checks: "HealthChecks", name: str = "serve-loop") -> None:
        checks.add_readyz_check(name, self.check)


class HealthChecks:
    """Named check registry; a check passes unless it raises."""

    def __init__(self):
        self._healthz: dict[str, Callable[[], None]] = {}
        self._readyz: dict[str, Callable[[], None]] = {}

    def add_healthz_check(self, name: str, fn: Callable[[], None]) -> None:
        self._healthz[name] = fn

    def add_readyz_check(self, name: str, fn: Callable[[], None]) -> None:
        self._readyz[name] = fn

    def _run(self, checks: dict) -> tuple[bool, dict]:
        detail = {}
        ok = True
        for name, fn in checks.items():
            try:
                fn()
                detail[name] = "ok"
            except Exception as err:
                ok = False
                detail[name] = f"error: {err}"
        return ok, detail

    def healthz(self) -> tuple[bool, dict]:
        return self._run(self._healthz)

    def readyz(self) -> tuple[bool, dict]:
        return self._run(self._readyz)

    def handle(self, path: str) -> tuple[int, str]:
        """Route a probe request path to (status code, body)."""
        if path.rstrip("/") == "/healthz":
            ok, detail = self.healthz()
        elif path.rstrip("/") == "/readyz":
            ok, detail = self.readyz()
        else:
            return 404, "not found"
        return (200 if ok else 500), json.dumps(detail)


class HealthServer:
    """Serves a HealthChecks registry on the probe address."""

    def __init__(self, checks: HealthChecks, host: str = "127.0.0.1", port: int = 0):
        self.checks = checks
        registry = self.checks

        class Handler(BaseHTTPRequestHandler):
            # Avoid Nagle+delayed-ACK ~40ms stalls per request.
            disable_nagle_algorithm = True
            def do_GET(self):  # noqa: N802 (http.server API)
                code, body = registry.handle(self.path)
                payload = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def log_message(self, *args):
                pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread: threading.Thread | None = None

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
