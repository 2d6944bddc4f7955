"""Kubernetes Event recording (client-go record.EventRecorder analog).

The port's own copy of ``kubeflow_tpu/k8s/events.py``: the same Event
names (``{object}.{sha1(kind/name/reason/message)[:10]}``), so a repeated
event bumps ``count`` on one object instead of creating another, and the
same fields.
"""

from __future__ import annotations

import hashlib

from kubeflow_tpu_torch.k8s.client import Client
from kubeflow_tpu_torch.k8s.errors import AlreadyExistsError, NotFoundError


class EventRecorder:
    def __init__(self, client: Client, component: str = "notebook-controller"):
        self.client = client
        self.component = component

    def eventf(
        self,
        obj: dict,
        event_type: str,  # Normal | Warning
        reason: str,
        message: str,
    ) -> dict:
        """Create (or bump the count of) an Event for ``obj``."""
        namespace = obj.get("metadata", {}).get("namespace", "default")
        involved = {
            "apiVersion": obj.get("apiVersion", ""),
            "kind": obj.get("kind", ""),
            "name": obj.get("metadata", {}).get("name", ""),
            "namespace": namespace,
            "uid": obj.get("metadata", {}).get("uid", ""),
        }
        digest = hashlib.sha1(
            f"{involved['kind']}/{involved['name']}/{reason}/{message}".encode()
        ).hexdigest()[:10]
        name = f"{involved['name']}.{digest}"
        try:
            existing = self.client.get("Event", name, namespace)
            existing["count"] = existing.get("count", 1) + 1
            return self.client.update(existing)
        except NotFoundError:
            pass
        event = {
            "apiVersion": "v1",
            "kind": "Event",
            "metadata": {"name": name, "namespace": namespace},
            "involvedObject": involved,
            "type": event_type,
            "reason": reason,
            "message": message,
            "count": 1,
            "source": {"component": self.component},
        }
        try:
            return self.client.create(event)
        except AlreadyExistsError:
            return event


def events_for(client: Client, kind: str, name: str, namespace: str) -> list[dict]:
    """All Events whose involvedObject matches (test/diagnosis helper)."""
    out = []
    for ev in client.list("Event", namespace):
        inv = ev.get("involvedObject", {})
        if inv.get("kind") == kind and inv.get("name") == name:
            out.append(ev)
    return out
