"""Real Kubernetes API-server client: the production Client implementation.

The port's own copy of ``kubeflow_tpu/k8s/real.py``.

client-go's role, stdlib-only. Satisfies the same ``Client`` protocol the
controllers use against FakeCluster, plus the watch-stream surface the
Manager drains (``drain_events``/``wait_for_events``), so the entire
control plane runs unchanged against a live apiserver (reference
components/notebook-controller/main.go:58-148 — ctrl.GetConfigOrDie +
mgr.Start wire exactly this).

Auth, in order (reference: client-go rest.InClusterConfig / kubeconfig):
- in-cluster: ``KUBERNETES_SERVICE_HOST`` + serviceaccount token/ca files,
- ``$KUBECONFIG`` (or ``~/.kube/config``): current-context cluster/user,
  supporting token, token-file, client-cert, and insecure-skip-verify.

Watches follow the list-then-watch informer contract: one LIST per kind
seeds synthetic ADDED events and a resourceVersion; the WATCH resumes from
it, bookmarks advance it, and 410 Gone falls back to relist. Events land in
an in-process ordered stream identical in shape to FakeCluster's.
"""

from __future__ import annotations

import json
import logging
import os
import ssl
import tempfile
import threading
from dataclasses import dataclass
from http.client import (
    HTTPConnection,
    HTTPException,
    HTTPResponse,
    HTTPSConnection,
)
from pathlib import Path
from typing import Iterator, Optional

from kubeflow_tpu_torch.k8s import rest
from kubeflow_tpu_torch.k8s.errors import (
    AlreadyExistsError,
    ApiError,
    ConflictError,
    InvalidError,
    NotFoundError,
    WebhookDeniedError,
)
from kubeflow_tpu_torch.k8s.fake import WatchEvent

log = logging.getLogger(__name__)

SERVICEACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class ConfigError(RuntimeError):
    """No usable cluster configuration found."""


@dataclass
class ClusterConfig:
    """Connection + auth material for one apiserver."""

    host: str
    port: int = 443
    scheme: str = "https"
    token: str = ""
    token_file: str = ""
    ca_file: str = ""
    client_cert_file: str = ""
    client_key_file: str = ""
    insecure_skip_verify: bool = False
    namespace: str = ""  # the SA namespace, when in-cluster

    # -- factories ---------------------------------------------------------

    @classmethod
    def in_cluster(cls, env: Optional[dict] = None, sa_dir: str = SERVICEACCOUNT_DIR) -> "ClusterConfig":
        env = env if env is not None else dict(os.environ)
        host = env.get("KUBERNETES_SERVICE_HOST", "")
        port = int(env.get("KUBERNETES_SERVICE_PORT", "443") or 443)
        token_file = os.path.join(sa_dir, "token")
        ca_file = os.path.join(sa_dir, "ca.crt")
        ns_file = os.path.join(sa_dir, "namespace")
        if not host or not os.path.exists(token_file):
            raise ConfigError("not running in a cluster (no service host/token)")
        namespace = ""
        try:
            namespace = Path(ns_file).read_text().strip()
        except OSError:
            pass
        return cls(
            host=host, port=port, token_file=token_file,
            ca_file=ca_file if os.path.exists(ca_file) else "",
            namespace=namespace,
        )

    @classmethod
    def from_kubeconfig(cls, path: str, context: str = "") -> "ClusterConfig":
        import base64

        import yaml

        try:
            doc = yaml.safe_load(Path(path).read_text())
        except OSError as err:
            raise ConfigError(f"cannot read kubeconfig {path}: {err}") from err
        if not isinstance(doc, dict):
            raise ConfigError(f"kubeconfig {path} is not a mapping")
        ctx_name = context or doc.get("current-context", "")
        ctx = _named(doc.get("contexts", []), ctx_name).get("context", {})
        cluster = _named(doc.get("clusters", []), ctx.get("cluster", "")).get("cluster", {})
        user = _named(doc.get("users", []), ctx.get("user", "")).get("user", {})

        server = cluster.get("server", "")
        if not server:
            raise ConfigError(f"kubeconfig {path}: no server for context {ctx_name!r}")
        scheme, _, rest_part = server.partition("://")
        hostport = rest_part.split("/", 1)[0]
        host, _, port_s = hostport.partition(":")
        port = int(port_s) if port_s else (443 if scheme == "https" else 80)

        def _materialize(data_key: str, file_key: str, src: dict) -> str:
            """Inline *-data beats a file path (kubeconfig precedence)."""
            data = src.get(data_key)
            if data:
                tmp = tempfile.NamedTemporaryFile(
                    mode="wb", delete=False, prefix="kftpu-", suffix=".pem"
                )
                tmp.write(base64.b64decode(data))
                tmp.close()
                return tmp.name
            return src.get(file_key, "")

        return cls(
            host=host,
            port=port,
            scheme=scheme or "https",
            token=user.get("token", ""),
            token_file=user.get("tokenFile", ""),
            ca_file=_materialize("certificate-authority-data", "certificate-authority", cluster),
            client_cert_file=_materialize("client-certificate-data", "client-certificate", user),
            client_key_file=_materialize("client-key-data", "client-key", user),
            insecure_skip_verify=bool(cluster.get("insecure-skip-verify", False)),
            namespace=ctx.get("namespace", ""),
        )

    @classmethod
    def from_env(cls, env: Optional[dict] = None) -> "ClusterConfig":
        """in-cluster first, then $KUBECONFIG, then ~/.kube/config."""
        env = env if env is not None else dict(os.environ)
        try:
            return cls.in_cluster(env)
        except ConfigError:
            pass
        kubeconfig = env.get("KUBECONFIG", "")
        if kubeconfig:
            return cls.from_kubeconfig(kubeconfig.split(os.pathsep)[0])
        home = env.get("HOME") or os.path.expanduser("~")
        default = os.path.join(home, ".kube", "config")
        if os.path.exists(default):
            return cls.from_kubeconfig(default)
        raise ConfigError(
            "no cluster configuration: not in-cluster, no $KUBECONFIG, "
            "no ~/.kube/config"
        )

    # -- connection --------------------------------------------------------

    def bearer_token(self) -> str:
        if self.token:
            return self.token
        if self.token_file:
            try:
                # Re-read every call: SA tokens rotate (BoundServiceAccountTokenVolume).
                return Path(self.token_file).read_text().strip()
            except OSError:
                return ""
        return ""

    def make_connection(self, timeout: Optional[float] = 30.0):
        # (Client-side TCP_NODELAY is already set by http.client's
        # connect(); the server handlers disable Nagle too — both sides
        # matter for the ~40ms delayed-ACK stall per request.)
        if self.scheme == "http":
            return HTTPConnection(self.host, self.port, timeout=timeout)
        ctx = ssl.create_default_context()
        if self.ca_file:
            ctx.load_verify_locations(self.ca_file)
        if self.client_cert_file:
            ctx.load_cert_chain(self.client_cert_file, self.client_key_file or None)
        if self.insecure_skip_verify:
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        return HTTPSConnection(self.host, self.port, context=ctx, timeout=timeout)


def _named(items: list, name: str) -> dict:
    for item in items or []:
        if item.get("name") == name:
            return item
    return {}


def _error_for(status: int, body: bytes) -> ApiError:
    message = ""
    reason = ""
    try:
        doc = json.loads(body or b"{}")
        message = doc.get("message", "")
        reason = doc.get("reason", "")
    except (json.JSONDecodeError, AttributeError):
        message = body.decode(errors="replace")[:300]
    if status == 404:
        return NotFoundError(message or "not found")
    if status == 409:
        if reason == "AlreadyExists":
            return AlreadyExistsError(message or "already exists")
        return ConflictError(message or "conflict")
    if status in (400, 422):
        return InvalidError(message or "invalid")
    if status == 403 and "admission webhook" in message:
        return WebhookDeniedError(message)
    err = ApiError(message or f"HTTP {status}")
    err.code = status
    return err


class RealClient:
    """HTTP Client + watch source against a live kube-apiserver."""

    def __init__(self, config: ClusterConfig, user_agent: str = "kubeflow-tpu-controller"):
        self.config = config
        self.user_agent = user_agent
        # Per-THREAD keep-alive connections. A shared connection would need
        # a lock, and a lock deadlocks re-entrant paths: a reconciler's
        # in-flight update triggers admission, whose webhook handler reads
        # through this same client from the webhook server's thread.
        self._local = threading.local()
        # Watch event stream (FakeCluster-compatible surface for Manager).
        # Cursors are ABSOLUTE counters; the drained prefix is discarded
        # (``_events_base`` tracks how much) so a long-running process
        # doesn't hold every event ever seen. One consumer per client.
        self.events: list[WatchEvent] = []
        self._events_base = 0
        self._events_lock = threading.Lock()
        self._events_cond = threading.Condition(self._events_lock)
        self._watchers: list[_Watcher] = []
        self._stopped = threading.Event()

    # -- HTTP plumbing -----------------------------------------------------

    def _headers(self, content_type: str = "") -> dict:
        headers = {
            "Accept": "application/json",
            "User-Agent": self.user_agent,
        }
        token = self.config.bearer_token()
        if token:
            headers["Authorization"] = f"Bearer {token}"
        if content_type:
            headers["Content-Type"] = content_type
        return headers

    def _request(
        self,
        method: str,
        path: str,
        body: Optional[dict] = None,
        content_type: str = "application/json",
    ) -> dict:
        payload = json.dumps(body).encode() if body is not None else None
        last_err: Optional[Exception] = None
        for attempt in range(2):  # one reconnect on a dead keep-alive socket
            conn = getattr(self._local, "conn", None)
            try:
                if conn is None:
                    conn = self._local.conn = self.config.make_connection()
                conn.request(
                    method, path, body=payload,
                    headers=self._headers(content_type if payload else ""),
                )
                resp = conn.getresponse()
                data = resp.read()
                status = resp.status
            except (OSError, ssl.SSLError, HTTPException) as err:
                # HTTPException covers IncompleteRead/BadStatusLine/
                # CannotSendRequest from a dead keep-alive socket — the
                # poisoned connection must be dropped, not cached.
                try:
                    conn.close()
                except Exception:
                    pass
                self._local.conn = None
                last_err = err
                continue
            if status >= 400:
                raise _error_for(status, data)
            return json.loads(data) if data else {}
        raise ApiError(f"apiserver unreachable: {last_err}")

    # -- Client protocol ---------------------------------------------------

    def get(self, kind: str, name: str, namespace: str = "") -> dict:
        obj = self._request("GET", rest.object_path(kind, name, namespace))
        return _ensure_tkg(obj, kind)

    def list(
        self,
        kind: str,
        namespace: str = "",
        label_selector: Optional[dict] = None,
        field_selector: Optional[dict] = None,
    ) -> list[dict]:
        path = rest.collection_path(kind, namespace) + rest.list_query(
            label_selector, field_selector=field_selector
        )
        doc = self._request("GET", path)
        return [_ensure_tkg(item, kind) for item in doc.get("items", [])]

    def create(self, obj: dict) -> dict:
        kind = obj.get("kind", "")
        obj = _ensure_tkg(dict(obj), kind)
        ns = obj.get("metadata", {}).get("namespace", "")
        out = self._request("POST", rest.collection_path(kind, ns), body=obj)
        return _ensure_tkg(out, kind)

    def update(self, obj: dict) -> dict:
        kind = obj.get("kind", "")
        obj = _ensure_tkg(dict(obj), kind)
        meta = obj.get("metadata", {})
        path = rest.object_path(kind, meta.get("name", ""), meta.get("namespace", ""))
        return _ensure_tkg(self._request("PUT", path, body=obj), kind)

    def update_status(self, obj: dict) -> dict:
        kind = obj.get("kind", "")
        obj = _ensure_tkg(dict(obj), kind)
        meta = obj.get("metadata", {})
        path = rest.status_path(kind, meta.get("name", ""), meta.get("namespace", ""))
        return _ensure_tkg(self._request("PUT", path, body=obj), kind)

    def patch(self, kind: str, name: str, namespace: str, patch: dict) -> dict:
        out = self._request(
            "PATCH",
            rest.object_path(kind, name, namespace),
            body=patch,
            content_type="application/merge-patch+json",
        )
        return _ensure_tkg(out, kind)

    def delete(self, kind: str, name: str, namespace: str = "") -> None:
        self._request("DELETE", rest.object_path(kind, name, namespace))

    def exists(self, kind: str, name: str, namespace: str = "") -> bool:
        try:
            self.get(kind, name, namespace)
            return True
        except NotFoundError:
            return False

    # -- watch machinery ---------------------------------------------------

    def start_watches(self, kinds: list[str], namespace: str = "") -> None:
        """One list-then-watch loop per kind, feeding the shared stream."""
        for kind in kinds:
            if any(w.kind == kind for w in self._watchers):
                continue
            watcher = _Watcher(self, kind, namespace)
            self._watchers.append(watcher)
            watcher.start()

    def wait_for_events(self, cursor: int, timeout: float) -> bool:
        """Block until events beyond ``cursor`` exist (or timeout)."""
        with self._events_cond:
            if self._events_base + len(self.events) > cursor:
                return True
            self._events_cond.wait(timeout)
            return self._events_base + len(self.events) > cursor

    def drain_events(self, cursor: int) -> tuple[list[WatchEvent], int]:
        with self._events_lock:
            start = max(0, cursor - self._events_base)
            new = list(self.events[start:])
            # Drop everything up to and including what this drain returned;
            # the absolute counter keeps older cursors harmless (they just
            # miss already-consumed history, which a single consumer never
            # asks for).
            consumed = start + len(new)
            del self.events[:consumed]
            self._events_base += consumed
            return new, self._events_base

    def _push_event(self, ev: WatchEvent) -> None:
        with self._events_cond:
            self.events.append(ev)
            self._events_cond.notify_all()

    def stop(self) -> None:
        self._stopped.set()
        for w in self._watchers:
            w.stop()
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            try:
                conn.close()
            except Exception:
                pass
            self._local.conn = None


def _ensure_tkg(obj: dict, kind: str) -> dict:
    """List items come back without apiVersion/kind; controllers rely on both."""
    if kind and not obj.get("kind"):
        obj["kind"] = kind
        obj.setdefault("apiVersion", rest.info_for(kind).api_version)
    return obj


class _RelistRequired(ApiError):
    """Watch resourceVersion expired (410 Gone): list-then-watch again."""


class _Watcher(threading.Thread):
    """List-then-watch loop for one kind (an informer's reflector).

    client-go reflector semantics (consumed by the reference at
    components/notebook-controller/main.go:58-148):
    - every watch request carries ``timeoutSeconds`` so the server closes
      the stream on a bounded cadence (clean EOF → resume from last rv),
    - the watch socket carries a READ DEADLINE slightly past that server
      timeout plus TCP keepalive, so a silently-dead peer (NAT drop,
      node freeze) surfaces as a timeout instead of wedging the watcher
      forever,
    - transient connection errors RESUME the watch from the last-seen
      resourceVersion — no relist, no duplicate-ADDED reseed storm; only
      410 Gone (or repeated resume failures) falls back to a full relist.
    """

    RELIST_BACKOFF = (0.2, 0.5, 1.0, 2.0, 5.0)
    # Server-side stream cadence; client-go uses 5-10 min. The socket read
    # deadline adds slack for the final frame to arrive.
    WATCH_TIMEOUT_SECONDS = 240
    SOCKET_DEADLINE_SLACK = 30.0
    # After this many consecutive failed resume attempts, assume the rv is
    # poisoned (e.g. apiserver restored from backup) and relist.
    MAX_RESUME_FAILURES = 4

    def __init__(self, client: RealClient, kind: str, namespace: str):
        super().__init__(daemon=True, name=f"watch-{kind.lower()}")
        self.client = client
        self.kind = kind
        self.namespace = namespace
        self._stop = threading.Event()
        self._conn = None
        # Last rv DELIVERED to the stream — updated per event so a
        # mid-stream exception does not lose progress (resuming from the
        # pre-call rv would replay the whole delta window as duplicates).
        self._resume_rv = ""
        # Did the most recent watch attempt get a 2xx stream open? A
        # success resets the failure counters so they count CONSECUTIVE
        # failures, not lifetime disconnects (a healthy watcher must not
        # drift toward forced relists over days of routine reconnects).
        self._connected_ok = False

    def stop(self) -> None:
        self._stop.set()
        if self._conn is not None:
            try:
                self._conn.close()  # unblocks the blocking read
            except Exception:
                pass

    def run(self) -> None:
        backoff_idx = 0
        rv = ""
        resume_failures = 0
        while not self._stop.is_set():
            try:
                if not rv:
                    rv = self._list_and_seed()
                    backoff_idx = 0
                rv = self._watch_from(rv)
                backoff_idx = 0
                resume_failures = 0
            except _RelistRequired:
                self._resume_rv = ""
                if self._stop.is_set():
                    return
                log.info("watch %s: resourceVersion expired; relisting", self.kind)
                rv = ""
                resume_failures = 0
            except Exception as err:
                if self._stop.is_set():
                    return
                # Events already delivered before the failure advance the
                # resume point — never replay them.
                rv = self._resume_rv or rv
                if self._connected_ok:
                    # The failed cycle DID stream successfully first: this
                    # is a fresh disconnect, not the next in a failure run.
                    backoff_idx = 0
                    resume_failures = 0
                    self._connected_ok = False
                delay = self.RELIST_BACKOFF[min(backoff_idx, len(self.RELIST_BACKOFF) - 1)]
                backoff_idx += 1
                if rv:
                    resume_failures += 1
                    if resume_failures >= self.MAX_RESUME_FAILURES:
                        log.warning(
                            "watch %s: %s; %d failed resumes — relisting in %.1fs",
                            self.kind, err, resume_failures, delay,
                        )
                        rv = ""
                        resume_failures = 0
                    else:
                        log.warning(
                            "watch %s: %s; resuming from rv=%s in %.1fs",
                            self.kind, err, rv, delay,
                        )
                else:
                    log.warning("watch %s: %s; relisting in %.1fs", self.kind, err, delay)
                self._stop.wait(delay)

    def _list_and_seed(self) -> str:
        path = rest.collection_path(self.kind, self.namespace)
        doc = self.client._request("GET", path)
        for item in doc.get("items", []):
            item = _ensure_tkg(item, self.kind)
            meta = item.get("metadata", {})
            self.client._push_event(
                WatchEvent("ADDED", self.kind, meta.get("namespace", ""), meta.get("name", ""), item)
            )
        return doc.get("metadata", {}).get("resourceVersion", "")

    def _open_watch_connection(self):
        """Watch connection with a read deadline + TCP keepalive (a watch
        with no deadline on a silently-dead peer blocks forever)."""
        conn = self.client.config.make_connection(
            timeout=self.WATCH_TIMEOUT_SECONDS + self.SOCKET_DEADLINE_SLACK
        )
        conn.connect()
        sock = conn.sock
        try:
            import socket as socketmod

            sock.setsockopt(socketmod.SOL_SOCKET, socketmod.SO_KEEPALIVE, 1)
            # Linux knobs; absent on other platforms — keepalive still on.
            for opt, val in (
                ("TCP_KEEPIDLE", 30), ("TCP_KEEPINTVL", 10), ("TCP_KEEPCNT", 3),
            ):
                if hasattr(socketmod, opt):
                    sock.setsockopt(
                        socketmod.IPPROTO_TCP, getattr(socketmod, opt), val
                    )
        except OSError:  # pragma: no cover — keepalive is best-effort
            pass
        return conn

    def _watch_from(self, rv: str) -> str:
        """Stream watch events; returns the latest rv on clean EOF or a
        retriable disconnect (caller resumes), raises _RelistRequired on
        410 Gone."""
        self._resume_rv = rv
        while not self._stop.is_set():
            path = rest.collection_path(self.kind, self.namespace) + rest.list_query(
                watch=True, resource_version=rv, allow_bookmarks=True,
                timeout_seconds=self.WATCH_TIMEOUT_SECONDS,
            )
            self._conn = self._open_watch_connection()
            try:
                self._conn.request("GET", path, headers=self.client._headers())
                resp = self._conn.getresponse()
                if resp.status == 410:
                    resp.read()
                    raise _RelistRequired("410 Gone: relist required")
                if resp.status >= 400:
                    raise _error_for(resp.status, resp.read())
                self._connected_ok = True
                for line in _iter_lines(resp):
                    if self._stop.is_set():
                        return rv
                    try:
                        ev = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    etype = ev.get("type", "")
                    obj = ev.get("object", {}) or {}
                    if etype == "BOOKMARK":
                        rv = obj.get("metadata", {}).get("resourceVersion", rv)
                        self._resume_rv = rv
                        continue
                    if etype == "ERROR":
                        code = obj.get("code", 0)
                        if code == 410:
                            raise _RelistRequired("410 Gone: relist required")
                        raise ApiError(f"watch error event: {obj.get('message', obj)}")
                    obj = _ensure_tkg(obj, self.kind)
                    meta = obj.get("metadata", {})
                    rv = meta.get("resourceVersion", rv)
                    self._resume_rv = rv
                    self.client._push_event(
                        WatchEvent(
                            etype, self.kind,
                            meta.get("namespace", ""), meta.get("name", ""), obj,
                        )
                    )
                # Clean EOF (server-side timeout): loop re-watches from rv.
            finally:
                try:
                    self._conn.close()
                except Exception:
                    pass
                self._conn = None
        return rv


def _iter_lines(resp: HTTPResponse) -> Iterator[bytes]:
    """Newline-delimited JSON frames from a (possibly chunked) stream."""
    buf = b""
    while True:
        chunk = resp.read1(65536) if hasattr(resp, "read1") else resp.read(65536)
        if not chunk:
            if buf.strip():
                yield buf
            return
        buf += chunk
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            if line.strip():
                yield line
