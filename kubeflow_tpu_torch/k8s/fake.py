"""In-memory Kubernetes API server.

The port's own copy of ``kubeflow_tpu/k8s/fake.py``, with the same
bookkeeping, so the same writes on either package's cluster leave the same
uids, resourceVersions and timestamps (from the injected clock):

- CRUD with uid / resourceVersion / generation bookkeeping,
- optimistic concurrency (stale resourceVersion → 409 Conflict),
- a status subresource (spec updates can't clobber status and vice versa),
- finalizers + deletionTimestamp two-phase delete,
- cascading garbage collection via ownerReferences,
- registered mutating/validating admission webhooks invoked on create/update,
- an ordered watch-event stream consumed by the Manager, whose cursors
  are absolute and survive ``compact_events``.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass
from typing import Callable, Optional

from kubeflow_tpu_torch.k8s import objects as obj_util
from kubeflow_tpu_torch.k8s.errors import (
    AlreadyExistsError,
    ConflictError,
    ExpiredError,
    InvalidError,
    NotFoundError,
)

CLUSTER_SCOPED_KINDS = {
    "Namespace",
    "Node",
    "ClusterRole",
    "ClusterRoleBinding",
    "CustomResourceDefinition",
    "OAuthClient",
    "Proxy",
    "APIServer",
    "PriorityClass",
}

# Kinds with a status subresource: plain update() preserves stored status.
STATUS_SUBRESOURCE_KINDS = {
    "Notebook",
    "StatefulSet",
    "Deployment",
    "Pod",
    "HTTPRoute",
    "Gateway",
    "DataSciencePipelinesApplication",
}


@dataclass
class AdmissionRequest:
    operation: str  # CREATE | UPDATE | DELETE
    object: dict
    old_object: Optional[dict] = None


@dataclass
class WatchEvent:
    type: str  # ADDED | MODIFIED | DELETED
    kind: str
    namespace: str
    name: str
    object: dict


@dataclass
class _Webhook:
    fn: Callable
    operations: tuple[str, ...] = ("CREATE", "UPDATE")


class FakeCluster:
    """Dict-backed API server. Implements the Client protocol."""

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self._objects: dict[tuple[str, str, str], dict] = {}
        self._uid = 0
        self._clock = clock or time.time
        self._mutating: dict[str, list[_Webhook]] = {}
        self._validating: dict[str, list[_Webhook]] = {}
        self.events: list[WatchEvent] = []
        self.events_base = 0  # absolute index of events[0] (see compact_events)

    # -- internals ---------------------------------------------------------

    def _key(self, kind: str, name: str, namespace: str) -> tuple[str, str, str]:
        if kind in CLUSTER_SCOPED_KINDS:
            namespace = ""
        return (kind, namespace, name)

    def _now(self) -> str:
        return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(self._clock()))

    def _next_rv(self) -> str:
        """resourceVersions ARE event-log cursors: the object rv stamped
        before an ``_emit`` equals the log cursor AFTER that event, so a
        watch resuming from any object rv replays exactly the events that
        came later — the apiserver contract RealClient's reflector relies
        on when it resumes from the last-seen rv without relisting."""
        return str(self.events_base + len(self.events) + 1)

    def _emit(self, event_type: str, obj: dict) -> None:
        self.events.append(
            WatchEvent(
                event_type,
                obj.get("kind", ""),
                obj_util.namespace_of(obj),
                obj_util.name_of(obj),
                copy.deepcopy(obj),
            )
        )

    def _run_admission(
        self, operation: str, obj: dict, old: Optional[dict]
    ) -> dict:
        kind = obj.get("kind", "")
        req = AdmissionRequest(operation, obj, old)
        for hook in self._mutating.get(kind, []):
            if operation in hook.operations:
                result = hook.fn(req)
                if result is not None:
                    obj = result
                    req = AdmissionRequest(operation, obj, old)
        for hook in self._validating.get(kind, []):
            if operation in hook.operations:
                hook.fn(req)  # raises WebhookDeniedError to deny
        return obj

    # -- webhook registration (envtest WebhookInstallOptions analog) -------

    def register_mutating_webhook(
        self, kind: str, fn: Callable, operations: tuple[str, ...] = ("CREATE", "UPDATE")
    ) -> None:
        self._mutating.setdefault(kind, []).append(_Webhook(fn, operations))

    def register_validating_webhook(
        self, kind: str, fn: Callable, operations: tuple[str, ...] = ("CREATE", "UPDATE")
    ) -> None:
        self._validating.setdefault(kind, []).append(_Webhook(fn, operations))

    # -- Client protocol ---------------------------------------------------

    def get(self, kind: str, name: str, namespace: str = "") -> dict:
        key = self._key(kind, name, namespace)
        try:
            return copy.deepcopy(self._objects[key])
        except KeyError:
            raise NotFoundError(f"{kind} {namespace}/{name} not found") from None

    def list(
        self,
        kind: str,
        namespace: str = "",
        label_selector: Optional[dict] = None,
        field_selector: Optional[dict] = None,
    ) -> list[dict]:
        if kind in CLUSTER_SCOPED_KINDS:
            namespace = ""  # normalize like _key: a ns filter would hide all
        out = []
        for (k, ns, _), obj in sorted(self._objects.items()):
            if k != kind:
                continue
            if namespace and ns != namespace:
                continue
            if not obj_util.matches_labels(obj, label_selector):
                continue
            if not obj_util.matches_fields(obj, field_selector):
                continue
            out.append(copy.deepcopy(obj))
        return out

    def create(self, obj: dict) -> dict:
        obj = copy.deepcopy(obj)
        kind = obj.get("kind", "")
        if not kind or not obj_util.name_of(obj):
            raise InvalidError("object must have kind and metadata.name")
        key = self._key(kind, obj_util.name_of(obj), obj_util.namespace_of(obj))
        if key in self._objects:
            raise AlreadyExistsError(f"{kind} {key[1]}/{key[2]} already exists")
        obj = self._run_admission("CREATE", obj, None)
        # Admission may rewrite name/namespace; store under the final key.
        key = self._key(kind, obj_util.name_of(obj), obj_util.namespace_of(obj))
        if key in self._objects:
            raise AlreadyExistsError(f"{kind} {key[1]}/{key[2]} already exists")
        meta = obj.setdefault("metadata", {})
        self._uid += 1
        meta["uid"] = f"uid-{self._uid}"
        meta["resourceVersion"] = self._next_rv()
        meta["creationTimestamp"] = self._now()
        meta["generation"] = 1
        self._objects[key] = copy.deepcopy(obj)
        self._emit("ADDED", obj)
        return copy.deepcopy(obj)

    def update(self, obj: dict) -> dict:
        obj = copy.deepcopy(obj)
        kind = obj.get("kind", "")
        key = self._key(kind, obj_util.name_of(obj), obj_util.namespace_of(obj))
        stored = self._objects.get(key)
        if stored is None:
            raise NotFoundError(f"{kind} {key[1]}/{key[2]} not found")
        rv = obj.get("metadata", {}).get("resourceVersion")
        if rv is not None and rv != stored["metadata"]["resourceVersion"]:
            raise ConflictError(
                f"{kind} {key[2]}: resourceVersion {rv} is stale "
                f"(current {stored['metadata']['resourceVersion']})"
            )
        obj = self._run_admission("UPDATE", obj, copy.deepcopy(stored))
        meta = obj.setdefault("metadata", {})
        # Immutable/system-managed fields.
        meta["uid"] = stored["metadata"]["uid"]
        meta["creationTimestamp"] = stored["metadata"]["creationTimestamp"]
        if "deletionTimestamp" in stored["metadata"]:
            meta["deletionTimestamp"] = stored["metadata"]["deletionTimestamp"]
        if kind in STATUS_SUBRESOURCE_KINDS and "status" in stored:
            obj["status"] = copy.deepcopy(stored["status"])
        if obj.get("spec") != stored.get("spec"):
            meta["generation"] = stored["metadata"].get("generation", 1) + 1
        else:
            meta["generation"] = stored["metadata"].get("generation", 1)
        # No-op update: nothing changed besides (possibly) the caller echoing
        # back the stored state — skip the event so controllers quiesce.
        meta["resourceVersion"] = stored["metadata"]["resourceVersion"]
        if obj == stored:
            return copy.deepcopy(obj)
        meta["resourceVersion"] = self._next_rv()
        # Deletion completes once finalizers are emptied.
        if "deletionTimestamp" in meta and not meta.get("finalizers"):
            self._remove(key, obj)
            return copy.deepcopy(obj)
        self._objects[key] = copy.deepcopy(obj)
        self._emit("MODIFIED", obj)
        return copy.deepcopy(obj)

    def update_status(self, obj: dict) -> dict:
        kind = obj.get("kind", "")
        key = self._key(kind, obj_util.name_of(obj), obj_util.namespace_of(obj))
        stored = self._objects.get(key)
        if stored is None:
            raise NotFoundError(f"{kind} {key[1]}/{key[2]} not found")
        rv = obj.get("metadata", {}).get("resourceVersion")
        if rv is not None and rv != stored["metadata"]["resourceVersion"]:
            raise ConflictError(f"{kind} {key[2]}: stale resourceVersion on status")
        if stored.get("status", {}) == obj.get("status", {}):
            return copy.deepcopy(stored)  # no-op: no event, no RV bump
        stored = copy.deepcopy(stored)
        stored["status"] = copy.deepcopy(obj.get("status", {}))
        stored["metadata"]["resourceVersion"] = self._next_rv()
        self._objects[key] = stored
        self._emit("MODIFIED", stored)
        return copy.deepcopy(stored)

    def patch(self, kind: str, name: str, namespace: str, patch: dict) -> dict:
        stored = self.get(kind, name, namespace)
        merged = obj_util.merge_patch(stored, patch)
        # Merge patches carry no resourceVersion expectation.
        merged["metadata"]["resourceVersion"] = stored["metadata"]["resourceVersion"]
        return self.update(merged)

    def delete(self, kind: str, name: str, namespace: str = "") -> None:
        key = self._key(kind, name, namespace)
        stored = self._objects.get(key)
        if stored is None:
            raise NotFoundError(f"{kind} {namespace}/{name} not found")
        self._run_admission("DELETE", copy.deepcopy(stored), copy.deepcopy(stored))
        meta = stored["metadata"]
        if meta.get("finalizers"):
            if "deletionTimestamp" not in meta:
                meta["deletionTimestamp"] = self._now()
                meta["resourceVersion"] = self._next_rv()
                self._emit("MODIFIED", stored)
            return
        self._remove(key, stored)

    def _remove(self, key: tuple[str, str, str], obj: dict) -> None:
        self._objects.pop(key, None)
        # Deletion is a write: stamp a fresh rv so the DELETED event slots
        # into the log ordering (resuming past it must not replay it).
        obj.setdefault("metadata", {})["resourceVersion"] = self._next_rv()
        self._emit("DELETED", obj)
        self._collect_garbage(obj["metadata"].get("uid"))

    def _collect_garbage(self, owner_uid: Optional[str]) -> None:
        if not owner_uid:
            return
        doomed = [
            (k, o)
            for k, o in list(self._objects.items())
            if any(
                ref.get("uid") == owner_uid
                for ref in o.get("metadata", {}).get("ownerReferences", [])
            )
        ]
        for (kind, ns, name), _ in doomed:
            try:
                self.delete(kind, name, ns)
            except NotFoundError:
                pass

    # -- test conveniences -------------------------------------------------

    def exists(self, kind: str, name: str, namespace: str = "") -> bool:
        return self._key(kind, name, namespace) in self._objects

    def drain_events(self, cursor: int) -> tuple[list[WatchEvent], int]:
        """Events appended since absolute ``cursor``; returns
        (events, new_cursor). Cursors are ABSOLUTE: compaction
        (``compact_events``) advances ``events_base`` without renumbering,
        and a cursor that falls below the compaction horizon raises
        ExpiredError — the apiserver's 410 Gone contract."""
        if cursor < self.events_base:
            raise ExpiredError(
                f"event cursor {cursor} predates compaction horizon "
                f"{self.events_base}"
            )
        start = cursor - self.events_base
        new = self.events[start:]
        return new, self.events_base + len(self.events)

    def event_cursor(self) -> int:
        """Absolute cursor one past the newest event (list resourceVersion)."""
        return self.events_base + len(self.events)

    def compact_events(self, keep_last: int) -> None:
        """Drop all but the newest ``keep_last`` log entries. Watchers
        positioned before the new horizon get ExpiredError (→ 410 Gone)
        on their next drain and must relist. Bounds the log's memory for
        long-running servers (a real apiserver compacts etcd the same way)."""
        drop = max(0, len(self.events) - keep_last)
        if drop:
            del self.events[:drop]
            self.events_base += drop
