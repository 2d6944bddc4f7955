"""envtest analog: a real HTTP apiserver façade over FakeCluster.

The reference's integration tier boots actual kube-apiserver + etcd
binaries (envtest — reference components/odh-notebook-controller/
controllers/suite_test.go:93-303). Those binaries don't exist in this
environment, so this module serves the FakeCluster's storage over the
Kubernetes REST dialect instead: list/watch with resourceVersion resume,
CRUD with typed Status errors, the status subresource, merge-patch, and
bearer-token auth. RealClient speaks to it exactly as it would to a live
apiserver, which is what makes the managers' production wiring testable
end-to-end without a cluster.

Watch resourceVersions here are cursors into the FakeCluster event log —
opaque strings to clients, which is all the Kubernetes API contract
promises.

The port's own copy of ``kubeflow_tpu/k8s/envtest.py``, over the port's
``FakeCluster``, with one stated difference: it enforces no CRD schema.
JAX's server checks every write against ``config/crd/bases/``, the TPU
CRDs, whose ``spec.tpu`` schema refuses ``spec.gpu`` notebooks; the port
has no CRD of its own yet, so it reads none (no ``crd_dir``), and a
write that a CRD would refuse with 422 is stored here.
"""

from __future__ import annotations

import base64
import json
import re
import ssl as ssl_mod
import threading
import urllib.request
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, unquote, urlparse

from kubeflow_tpu_torch.k8s import rest
from kubeflow_tpu_torch.k8s.errors import ApiError, WebhookDeniedError
from kubeflow_tpu_torch.k8s.fake import FakeCluster

# resource (plural) → kind, derived from the same table the client uses.
_RESOURCE_TO_KIND = {
    (info.group, info.resource): kind for kind, info in rest.KINDS.items()
}

_CORE_RE = re.compile(r"^/api/v1(?:/namespaces/(?P<ns>[^/]+))?/(?P<res>[^/]+)(?:/(?P<name>[^/]+))?(?P<status>/status)?$")
_GROUP_RE = re.compile(r"^/apis/(?P<group>[^/]+)/(?P<version>[^/]+)(?:/namespaces/(?P<ns>[^/]+))?/(?P<res>[^/]+)(?:/(?P<name>[^/]+))?(?P<status>/status)?$")


class _Route:
    def __init__(self, kind: str, namespace: str, name: str, status: bool):
        self.kind = kind
        self.namespace = namespace
        self.name = name
        self.status = status


def _parse_path(path: str) -> Optional[_Route]:
    m = _CORE_RE.match(path)
    group = ""
    if not m:
        m = _GROUP_RE.match(path)
        if not m:
            return None
        group = m.group("group")
    kind = _RESOURCE_TO_KIND.get((group, m.group("res")))
    if kind is None:
        return None
    return _Route(
        kind,
        unquote(m.group("ns") or ""),
        unquote(m.group("name") or ""),
        bool(m.group("status")),
    )


def _selector_from_query(qs: dict, key: str = "labelSelector") -> Optional[dict]:
    raw = (qs.get(key) or [""])[0]
    if not raw:
        return None
    out = {}
    for part in raw.split(","):
        k, _, v = part.partition("=")
        if k:
            out[k] = v
    return out


class EnvtestServer:
    """Threaded HTTP apiserver over a FakeCluster.

    ``lock`` guards every cluster access; test code mutating the backing
    cluster directly (FakeKubelet steps, fixtures) must hold it too.
    """

    # Event-log compaction: when the log exceeds 2x this, the oldest half
    # is dropped — watchers resuming from before the horizon get 410 Gone
    # and relist, exactly the etcd-compaction behavior a real apiserver
    # shows. 0 disables (unbounded log).
    MAX_EVENT_LOG = 8192

    def __init__(
        self,
        cluster: Optional[FakeCluster] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        token: str = "",
        max_event_log: Optional[int] = None,
    ):
        self.cluster = cluster or FakeCluster()
        self.lock = threading.RLock()
        # Watch streams block on this instead of polling: every write verb
        # notifies under the lock, so a reconcile chain's per-hop latency
        # is wakeup latency, not a poll interval.
        self.event_cond = threading.Condition(self.lock)
        self.token = token
        self.max_event_log = (
            self.MAX_EVENT_LOG if max_event_log is None else max_event_log
        )
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # Nagle + delayed-ACK costs ~40ms per hop on
            # loopback; reconcile chains multiply it.
            disable_nagle_algorithm = True

            # -- plumbing --------------------------------------------------
            def log_message(self, *args):
                pass

            def _reply(self, code: int, doc: dict) -> None:
                payload = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def _reply_error(self, err: ApiError) -> None:
                message = str(err)
                if isinstance(err, WebhookDeniedError):
                    message = f"admission webhook denied the request: {message}"
                self._reply(
                    err.code,
                    {
                        "kind": "Status",
                        "apiVersion": "v1",
                        "status": "Failure",
                        "reason": err.reason,
                        "code": err.code,
                        "message": message,
                    },
                )

            def _authorized(self) -> bool:
                if not outer.token:
                    return True
                header = self.headers.get("Authorization", "")
                if header == f"Bearer {outer.token}":
                    return True
                self._reply(
                    401,
                    {"kind": "Status", "status": "Failure", "reason": "Unauthorized",
                     "code": 401, "message": "invalid bearer token"},
                )
                return False

            def _body(self) -> dict:
                length = int(self.headers.get("Content-Length", 0))
                data = self.rfile.read(length) if length else b"{}"
                return json.loads(data or b"{}")

            # -- verbs -----------------------------------------------------
            def do_GET(self):  # noqa: N802
                if not self._authorized():
                    return
                url = urlparse(self.path)
                route = _parse_path(url.path)
                if route is None:
                    return self._reply(
                        404, {"kind": "Status", "code": 404, "reason": "NotFound",
                              "message": f"no such path {url.path}"})
                qs = parse_qs(url.query)
                try:
                    if route.name:
                        with outer.lock:
                            obj = outer.cluster.get(route.kind, route.name, route.namespace)
                        return self._reply(200, obj)
                    if (qs.get("watch") or ["false"])[0] == "true":
                        return self._stream_watch(route, qs)
                    selector = _selector_from_query(qs)
                    fields = _selector_from_query(qs, "fieldSelector")
                    with outer.lock:
                        items = outer.cluster.list(
                            route.kind, route.namespace, selector, fields
                        )
                        cursor = outer.cluster.event_cursor()
                    info = rest.info_for(route.kind)
                    return self._reply(200, {
                        "kind": f"{route.kind}List",
                        "apiVersion": info.api_version,
                        "metadata": {"resourceVersion": str(cursor)},
                        "items": items,
                    })
                except ApiError as err:
                    return self._reply_error(err)

            def _stream_watch(self, route: _Route, qs: dict) -> None:
                from kubeflow_tpu_torch.k8s.errors import ExpiredError

                try:
                    cursor = int((qs.get("resourceVersion") or ["0"])[0] or 0)
                except ValueError:
                    cursor = 0
                selector = _selector_from_query(qs)
                timeout_s = int((qs.get("timeoutSeconds") or ["0"])[0] or 0)
                # A resourceVersion behind the compaction horizon is 410
                # Gone BEFORE the stream opens (apiserver behavior): the
                # client must relist, not hang on an unresumable watch.
                try:
                    with outer.lock:
                        events, cursor = outer.cluster.drain_events(cursor)
                except ExpiredError as err:
                    return self._reply_error(err)
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Connection", "close")
                self.end_headers()
                import time as _time
                deadline = _time.monotonic() + timeout_s if timeout_s else None
                try:
                    while not outer._shutdown.is_set():
                        for ev in events:
                            if ev.kind != route.kind:
                                continue
                            if route.namespace and ev.namespace != route.namespace:
                                continue
                            if selector is not None:
                                from kubeflow_tpu_torch.k8s import objects as obj_util
                                if not obj_util.matches_labels(ev.object, selector):
                                    continue
                            frame = json.dumps(
                                {"type": ev.type, "object": ev.object}
                            ).encode() + b"\n"
                            self.wfile.write(frame)
                            self.wfile.flush()
                        if deadline and _time.monotonic() >= deadline:
                            return
                        try:
                            with outer.event_cond:
                                if (
                                    outer.cluster.event_cursor() <= cursor
                                    and not outer._shutdown.is_set()
                                ):
                                    # Wakes immediately on any write; the
                                    # cap bounds shutdown/deadline checks.
                                    outer.event_cond.wait(0.05)
                                events, cursor = outer.cluster.drain_events(cursor)
                        except ExpiredError:
                            # Compacted PAST an open stream (log overran the
                            # watcher): the in-band 410 ERROR frame, after
                            # which the client relists.
                            frame = json.dumps({
                                "type": "ERROR",
                                "object": {"kind": "Status", "code": 410,
                                           "reason": "Expired",
                                           "message": "too old resource version"},
                            }).encode() + b"\n"
                            self.wfile.write(frame)
                            self.wfile.flush()
                            return
                except (BrokenPipeError, ConnectionResetError):
                    return  # client went away

            def do_POST(self):  # noqa: N802
                if not self._authorized():
                    return
                route = _parse_path(urlparse(self.path).path)
                if route is None or route.name:
                    return self._reply(404, {"kind": "Status", "code": 404,
                                             "reason": "NotFound", "message": "bad path"})
                try:
                    obj = self._body()
                    obj.setdefault("kind", route.kind)
                    obj.setdefault("apiVersion", rest.info_for(route.kind).api_version)
                    if route.namespace:
                        obj.setdefault("metadata", {}).setdefault("namespace", route.namespace)
                    # Remote admission runs WITHOUT the cluster lock held:
                    # webhook handlers call back into this apiserver.
                    obj = outer._run_remote_admission(route.kind, "CREATE", obj, None)
                    with outer.lock:
                        created = outer.cluster.create(obj)
                        outer._maybe_compact()
                    return self._reply(201, created)
                except ApiError as err:
                    return self._reply_error(err)

            def do_PUT(self):  # noqa: N802
                if not self._authorized():
                    return
                route = _parse_path(urlparse(self.path).path)
                if route is None or not route.name:
                    return self._reply(404, {"kind": "Status", "code": 404,
                                             "reason": "NotFound", "message": "bad path"})
                try:
                    obj = self._body()
                    obj.setdefault("kind", route.kind)
                    obj.setdefault("apiVersion", rest.info_for(route.kind).api_version)
                    if route.status:
                        with outer.lock:
                            out = outer.cluster.update_status(obj)
                            outer._maybe_compact()
                        return self._reply(200, out)
                    with outer.lock:
                        old = outer.cluster.get(route.kind, route.name, route.namespace)
                    obj = outer._run_remote_admission(route.kind, "UPDATE", obj, old)
                    with outer.lock:
                        out = outer.cluster.update(obj)
                        outer._maybe_compact()
                    return self._reply(200, out)
                except ApiError as err:
                    return self._reply_error(err)

            def do_PATCH(self):  # noqa: N802
                if not self._authorized():
                    return
                route = _parse_path(urlparse(self.path).path)
                if route is None or not route.name:
                    return self._reply(404, {"kind": "Status", "code": 404,
                                             "reason": "NotFound", "message": "bad path"})
                try:
                    patch = self._body()
                    if route.kind in outer._remote_webhooks:
                        from kubeflow_tpu_torch.k8s import objects as obj_util

                        with outer.lock:
                            stored = outer.cluster.get(
                                route.kind, route.name, route.namespace
                            )
                        merged = obj_util.merge_patch(stored, patch)
                        merged["metadata"]["resourceVersion"] = stored["metadata"][
                            "resourceVersion"
                        ]
                        merged = outer._run_remote_admission(
                            route.kind, "UPDATE", merged, stored
                        )
                        with outer.lock:
                            out = outer.cluster.update(merged)
                            outer._maybe_compact()
                    else:
                        with outer.lock:
                            out = outer.cluster.patch(
                                route.kind, route.name, route.namespace, patch
                            )
                            outer._maybe_compact()
                    return self._reply(200, out)
                except ApiError as err:
                    return self._reply_error(err)

            def do_DELETE(self):  # noqa: N802
                if not self._authorized():
                    return
                route = _parse_path(urlparse(self.path).path)
                if route is None or not route.name:
                    return self._reply(404, {"kind": "Status", "code": 404,
                                             "reason": "NotFound", "message": "bad path"})
                try:
                    with outer.lock:
                        outer.cluster.delete(route.kind, route.name, route.namespace)
                        outer._maybe_compact()
                    return self._reply(200, {"kind": "Status", "status": "Success"})
                except ApiError as err:
                    return self._reply_error(err)

        self._shutdown = threading.Event()
        self._remote_webhooks: dict[str, _RemoteWebhook] = {}
        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    def _maybe_compact(self) -> None:
        """Bound the event log (call with ``lock`` held): past 2x the cap,
        drop the oldest half — stragglers see 410 and relist. Also the
        per-write chokepoint, so it wakes blocked watch streams."""
        if self.max_event_log and len(self.cluster.events) > 2 * self.max_event_log:
            self.cluster.compact_events(self.max_event_log)
        self.event_cond.notify_all()

    # -- remote admission (WebhookConfiguration analog) --------------------

    def add_remote_webhook(
        self,
        kind: str = "Notebook",
        mutate_url: str = "",
        validate_url: str = "",
        ca_file: str = "",
    ) -> None:
        """Register AdmissionReview endpoints called on CREATE/UPDATE of
        ``kind`` — what a Mutating/ValidatingWebhookConfiguration does on a
        real apiserver, including serving-cert verification via caBundle
        and failurePolicy: Fail on transport errors."""
        ctx = None
        if ca_file:
            ctx = ssl_mod.create_default_context(cafile=ca_file)
            ctx.check_hostname = False  # cert SAN is the in-cluster svc name
        self._remote_webhooks[kind] = _RemoteWebhook(mutate_url, validate_url, ctx)

    def _post_review(self, hook: _RemoteWebhook, url: str, operation: str,
                     obj: dict, old: Optional[dict]) -> dict:
        review = {
            "apiVersion": "admission.k8s.io/v1",
            "kind": "AdmissionReview",
            "request": {
                "uid": "envtest",
                "operation": operation,
                "object": obj,
                "oldObject": old,
            },
        }
        http_req = urllib.request.Request(
            url, data=json.dumps(review).encode(),
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(
                http_req, timeout=10, context=hook.ssl_context
            ) as resp:
                return json.loads(resp.read()).get("response", {})
        except Exception as err:  # failurePolicy: Fail
            raise WebhookDeniedError(f"webhook call failed: {err}") from err

    def _run_remote_admission(
        self, kind: str, operation: str, obj: dict, old: Optional[dict]
    ) -> dict:
        hook = self._remote_webhooks.get(kind)
        if hook is None:
            return obj
        if hook.mutate_url:
            response = self._post_review(hook, hook.mutate_url, operation, obj, old)
            if not response.get("allowed", False):
                raise WebhookDeniedError(
                    response.get("status", {}).get("message", "denied")
                )
            patch_b64 = response.get("patch", "")
            if patch_b64:
                from kubeflow_tpu_torch.webhook.server import apply_json_patch

                ops = json.loads(base64.b64decode(patch_b64))
                obj = apply_json_patch(obj, ops)
        if hook.validate_url:
            response = self._post_review(hook, hook.validate_url, operation, obj, old)
            if not response.get("allowed", False):
                raise WebhookDeniedError(
                    response.get("status", {}).get("message", "denied")
                )
        return obj

    @property
    def host(self) -> str:
        return self._server.server_address[0]

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> "EnvtestServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="envtest-apiserver"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._shutdown.set()
        with self.event_cond:
            self.event_cond.notify_all()  # release blocked watch streams
        self._server.shutdown()
        self._server.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    def client_config(self):
        """A ClusterConfig pointed at this server (plain HTTP)."""
        from kubeflow_tpu_torch.k8s.real import ClusterConfig

        return ClusterConfig(
            host=self.host, port=self.port, scheme="http", token=self.token
        )


@dataclass
class _RemoteWebhook:
    mutate_url: str = ""
    validate_url: str = ""
    ssl_context: Optional[object] = None
