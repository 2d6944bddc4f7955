"""AdmissionReview HTTPS server: the production webhook transport.

The port's own copy of ``kubeflow_tpu/webhook/server.py``. Reference
parity: the ODH manager runs controller-runtime's webhook server on :8443
with serving certs, exposing ``/mutate-notebook-v1`` and
``/validate-notebook-v1`` (reference components/odh-notebook-controller/
main.go:291-331; paths registered in notebook_mutating_webhook.go:54-68 and
notebook_validating_webhook.go:31-38), with the cluster TLS security
profile applied to the listener (main.go:237-269). This module does the
same: decode AdmissionReview v1, invoke the handler, encode an
AdmissionResponse with a granular RFC 6902 JSONPatch, over TLS terminated
in-process.

TLS behavior:
- ``cert_dir`` holds ``tls.crt``/``tls.key`` (the serving-cert Secret
  mount layout). Missing or unloadable certs FAIL CLOSED at start.
- The cluster ``TLSProfile`` sets the minimum TLS version and (for ≤1.2)
  the cipher list on the listener.
- Rotation: a background thread polls the cert files' mtimes and reloads
  the chain into the live SSLContext — new handshakes pick up the new
  certs without dropping the listener (cert-manager/service-ca rotate
  in place).
"""

from __future__ import annotations

import base64
import copy
import json
import logging
import os
import ssl
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from kubeflow_tpu_torch.controller.tls import TLSProfile
from kubeflow_tpu_torch.k8s.errors import WebhookDeniedError
from kubeflow_tpu_torch.k8s.fake import AdmissionRequest

log = logging.getLogger(__name__)

# AdmissionReview bodies are small (a Notebook object + envelope); the
# apiserver itself caps at ~3MB. Anything bigger is not an admission
# review — refuse before buffering it into host memory (413).
MAX_ADMISSION_BODY_BYTES = 4 << 20


def _read_body(handler: BaseHTTPRequestHandler, limit: int) -> bytes:
    """THE body read for admission handlers (the
    kftpu-unbounded-handler-read semgrep rule forbids bare rfile.read
    here): refuses Content-Length past ``limit`` before reading a byte.
    Raises ValueError past the limit or on garbage lengths."""
    length = int(handler.headers.get("Content-Length", 0))
    if length < 0 or length > limit:
        raise ValueError(f"Content-Length {length} outside [0, {limit}]")
    return handler.rfile.read(length)


MUTATE_PATH = "/mutate-notebook-v1"
VALIDATE_PATH = "/validate-notebook-v1"

CERT_FILE = "tls.crt"
KEY_FILE = "tls.key"

# IANA cipher-suite names (what the OpenShift APIServer CR speaks) →
# OpenSSL names (what ssl.SSLContext.set_ciphers takes). TLS 1.3 suites are
# not listed: OpenSSL fixes them independently of set_ciphers, and all
# three profile variants' 1.3 suites are the defaults anyway.
_IANA_TO_OPENSSL = {
    "TLS_ECDHE_ECDSA_WITH_AES_128_GCM_SHA256": "ECDHE-ECDSA-AES128-GCM-SHA256",
    "TLS_ECDHE_RSA_WITH_AES_128_GCM_SHA256": "ECDHE-RSA-AES128-GCM-SHA256",
    "TLS_ECDHE_ECDSA_WITH_AES_256_GCM_SHA384": "ECDHE-ECDSA-AES256-GCM-SHA384",
    "TLS_ECDHE_RSA_WITH_AES_256_GCM_SHA384": "ECDHE-RSA-AES256-GCM-SHA384",
    "TLS_ECDHE_ECDSA_WITH_CHACHA20_POLY1305_SHA256": "ECDHE-ECDSA-CHACHA20-POLY1305",
    "TLS_ECDHE_RSA_WITH_CHACHA20_POLY1305_SHA256": "ECDHE-RSA-CHACHA20-POLY1305",
    "TLS_ECDHE_ECDSA_WITH_AES_128_CBC_SHA256": "ECDHE-ECDSA-AES128-SHA256",
    "TLS_ECDHE_RSA_WITH_AES_128_CBC_SHA256": "ECDHE-RSA-AES128-SHA256",
    "TLS_RSA_WITH_AES_128_GCM_SHA256": "AES128-GCM-SHA256",
    "TLS_RSA_WITH_AES_256_GCM_SHA384": "AES256-GCM-SHA384",
}

_MIN_VERSIONS = {
    "VersionTLS10": ssl.TLSVersion.TLSv1,
    "VersionTLS11": ssl.TLSVersion.TLSv1_1,
    "VersionTLS12": ssl.TLSVersion.TLSv1_2,
    "VersionTLS13": ssl.TLSVersion.TLSv1_3,
}


class CertError(RuntimeError):
    """Serving certs missing/unreadable: the server refuses to start
    (failurePolicy: Fail means a silently-broken webhook blocks the API
    server; better to crash-loop visibly)."""


def _pointer_escape(key: str) -> str:
    """RFC 6901 token escaping."""
    return key.replace("~", "~0").replace("/", "~1")


def json_patch(old, new, path: str = "") -> list[dict]:
    """Granular RFC 6902 patch from ``old`` to ``new``.

    controller-runtime's PatchResponseFromRaw computes exactly this shape
    (via json-patch diff); granular ops matter because the API server
    applies each webhook's patch to the CURRENT intermediate object — a
    whole-root replace would clobber concurrent mutations from other
    webhooks in the chain.
    """
    if old == new:
        return []
    if isinstance(old, dict) and isinstance(new, dict):
        ops: list[dict] = []
        for key in old:
            esc = f"{path}/{_pointer_escape(key)}"
            if key not in new:
                ops.append({"op": "remove", "path": esc})
            else:
                ops.extend(json_patch(old[key], new[key], esc))
        for key in new:
            if key not in old:
                ops.append(
                    {"op": "add", "path": f"{path}/{_pointer_escape(key)}",
                     "value": new[key]}
                )
        return ops
    if isinstance(old, list) and isinstance(new, list):
        ops = []
        common = min(len(old), len(new))
        for i in range(common):
            ops.extend(json_patch(old[i], new[i], f"{path}/{i}"))
        # Remove from the tail backwards so indices stay valid.
        for i in range(len(old) - 1, common - 1, -1):
            ops.append({"op": "remove", "path": f"{path}/{i}"})
        for i in range(common, len(new)):
            ops.append({"op": "add", "path": f"{path}/-", "value": new[i]})
        return ops
    return [{"op": "replace", "path": path or "", "value": new}]


def apply_json_patch(doc, ops: list[dict]):
    """Apply an RFC 6902 patch (the subset ``json_patch`` emits) — the API
    server's side of the round-trip, used by tests to prove the emitted
    patch reproduces the handler's mutation exactly."""
    doc = copy.deepcopy(doc)
    for op in ops:
        path = op["path"]
        if path == "":
            doc = copy.deepcopy(op["value"])
            continue
        tokens = [t.replace("~1", "/").replace("~0", "~") for t in path.split("/")[1:]]
        parent = doc
        for tok in tokens[:-1]:
            parent = parent[int(tok)] if isinstance(parent, list) else parent[tok]
        last = tokens[-1]
        if isinstance(parent, list):
            if op["op"] == "add":
                if last == "-":
                    parent.append(op["value"])
                else:
                    parent.insert(int(last), op["value"])
            elif op["op"] == "remove":
                del parent[int(last)]
            else:
                parent[int(last)] = op["value"]
        else:
            if op["op"] == "remove":
                del parent[last]
            else:
                parent[last] = op["value"]
    return doc


def handle_admission_review(body: dict, mutating_handler, validating_handler) -> dict:
    """AdmissionReview(request) → AdmissionReview(response)."""
    request = body.get("request", {})
    uid = request.get("uid", "")
    operation = request.get("operation", "CREATE")
    obj = copy.deepcopy(request.get("object") or {})
    old_obj = request.get("oldObject") or None
    req = AdmissionRequest(operation=operation, object=obj, old_object=old_obj)

    response: dict = {"uid": uid, "allowed": True}
    try:
        if validating_handler is not None:
            validating_handler(req)
        if mutating_handler is not None:
            mutated = mutating_handler(req) or obj
            patch = json_patch(request.get("object") or {}, mutated)
            if patch:
                response["patchType"] = "JSONPatch"
                response["patch"] = base64.b64encode(
                    json.dumps(patch).encode()
                ).decode()
    except WebhookDeniedError as err:
        response = {
            "uid": uid,
            "allowed": False,
            "status": {"code": 403, "message": str(err)},
        }
    except Exception as err:  # fail closed, as failurePolicy: Fail expects
        response = {
            "uid": uid,
            "allowed": False,
            "status": {"code": 500, "message": f"webhook error: {err}"},
        }
    return {
        "apiVersion": "admission.k8s.io/v1",
        "kind": "AdmissionReview",
        "response": response,
    }


def make_ssl_context(
    cert_dir: str, tls_profile: Optional[TLSProfile] = None
) -> ssl.SSLContext:
    """Server context from a serving-cert dir, hardened per the profile."""
    cert = os.path.join(cert_dir, CERT_FILE)
    key = os.path.join(cert_dir, KEY_FILE)
    if not (os.path.exists(cert) and os.path.exists(key)):
        raise CertError(f"serving certs not found in {cert_dir} "
                        f"(need {CERT_FILE} + {KEY_FILE})")
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    try:
        ctx.load_cert_chain(cert, key)
    except (ssl.SSLError, OSError) as err:
        raise CertError(f"cannot load serving certs from {cert_dir}: {err}") from err
    if tls_profile is not None:
        ctx.minimum_version = _MIN_VERSIONS.get(
            tls_profile.min_version, ssl.TLSVersion.TLSv1_2
        )
        openssl_names = [
            _IANA_TO_OPENSSL[c] for c in tls_profile.ciphers if c in _IANA_TO_OPENSSL
        ]
        if openssl_names:
            try:
                ctx.set_ciphers(":".join(openssl_names))
            except ssl.SSLError as err:
                raise CertError(f"TLS profile cipher list rejected: {err}") from err
    else:
        ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    return ctx


class _CertReloader(threading.Thread):
    """Polls cert mtimes; reloads the chain into the live context."""

    def __init__(self, ctx: ssl.SSLContext, cert_dir: str, interval: float = 10.0):
        super().__init__(daemon=True, name="webhook-cert-reload")
        self.ctx = ctx
        self.cert_dir = cert_dir
        self.interval = interval
        self._stop = threading.Event()
        self._mtimes = self._stat()
        self.reloads = 0

    def _stat(self):
        out = {}
        for f in (CERT_FILE, KEY_FILE):
            try:
                out[f] = os.stat(os.path.join(self.cert_dir, f)).st_mtime_ns
            except OSError:
                out[f] = None
        return out

    def poll_once(self) -> bool:
        """Check and maybe reload; returns True when a reload happened."""
        current = self._stat()
        if current == self._mtimes:
            return False
        try:
            self.ctx.load_cert_chain(
                os.path.join(self.cert_dir, CERT_FILE),
                os.path.join(self.cert_dir, KEY_FILE),
            )
            self._mtimes = current
            self.reloads += 1
            log.info("webhook serving certs reloaded from %s", self.cert_dir)
            return True
        except (ssl.SSLError, OSError) as err:
            # Keep serving with the previous chain; retry next poll.
            log.error("cert rotation failed (keeping old chain): %s", err)
            return False

    def run(self) -> None:
        while not self._stop.wait(self.interval):
            self.poll_once()

    def stop(self) -> None:
        self._stop.set()


class WebhookServer:
    """Serves the two admission paths, TLS-terminated when certs are given.

    ``cert_dir=None`` falls back to plain HTTP for in-process tests and
    sidecar-terminated deployments; production manifests mount the
    serving-cert Secret and pass ``--cert-dir``.
    """

    def __init__(
        self,
        mutating_handler=None,
        validating_handler=None,
        host: str = "127.0.0.1",
        port: int = 0,
        cert_dir: Optional[str] = None,
        tls_profile: Optional[TLSProfile] = None,
        reload_interval: float = 10.0,
    ):
        mutating = mutating_handler
        validating = validating_handler

        class Handler(BaseHTTPRequestHandler):
            # Avoid Nagle+delayed-ACK ~40ms stalls per request.
            disable_nagle_algorithm = True
            # Bounds both the deferred TLS handshake and request reads: a
            # half-open client costs one handler thread for 30s, never the
            # accept loop.
            timeout = 30

            def setup(self):
                super().setup()
                if isinstance(self.connection, ssl.SSLSocket):
                    # Deferred handshake (see wrap_socket below) under this
                    # handler's timeout; failures close just this thread.
                    self.connection.do_handshake()

            def do_POST(self):  # noqa: N802 (http.server API)
                try:
                    raw = _read_body(self, MAX_ADMISSION_BODY_BYTES)
                except ValueError:
                    self.send_response(413)
                    self.end_headers()
                    return
                try:
                    body = json.loads(raw or b"{}")
                except json.JSONDecodeError:
                    self.send_response(400)
                    self.end_headers()
                    return
                if self.path == MUTATE_PATH:
                    review = handle_admission_review(body, mutating, None)
                elif self.path == VALIDATE_PATH:
                    review = handle_admission_review(body, None, validating)
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                payload = json.dumps(review).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def log_message(self, *args):
                pass

        class _QuietServer(ThreadingHTTPServer):
            daemon_threads = True

            def handle_error(self, request, client_address):
                # Handshake failures from probes/scans are expected noise;
                # a traceback per bad connection would flood the log.
                log.debug("webhook connection error from %s", client_address)

        self._server = _QuietServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None
        self._reloader: Optional[_CertReloader] = None
        self.tls_enabled = False
        if cert_dir:
            ctx = make_ssl_context(cert_dir, tls_profile)  # raises CertError: fail closed
            # do_handshake_on_connect=False: accept() returns immediately
            # and the handshake happens on the handler THREAD's first read.
            # Otherwise one client that connects and never speaks TLS
            # (port scan, half-open probe) wedges the accept loop and all
            # admission stops — failurePolicy: Fail would then block every
            # Notebook write cluster-wide.
            self._server.socket = ctx.wrap_socket(
                self._server.socket, server_side=True,
                do_handshake_on_connect=False,
            )
            self._reloader = _CertReloader(ctx, cert_dir, reload_interval)
            self.tls_enabled = True

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def cert_reloads(self) -> int:
        return self._reloader.reloads if self._reloader else 0

    def poll_certs(self) -> bool:
        """Force one rotation check now (tests; the thread does it live)."""
        return self._reloader.poll_once() if self._reloader else False

    def start(self) -> None:
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        if self._reloader is not None:
            self._reloader.start()

    def stop(self) -> None:
        if self._reloader is not None:
            self._reloader.stop()
        self._server.shutdown()
        self._server.server_close()
        if self._thread:
            self._thread.join(timeout=5)
