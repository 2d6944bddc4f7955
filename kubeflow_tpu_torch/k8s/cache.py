"""Cache memory-footprint transforms.

The port's own copy of ``kubeflow_tpu/k8s/cache.py``.

The ODH manager shrinks its informer cache by stripping the ``data`` payload
of every ConfigMap and Secret it does not actually read (reference
components/odh-notebook-controller/main.go:95-125 — transform funcs keep
data only for objects the reconciler consumes: CA-bundle sources, the
odh-trusted-ca-bundle, runtime-images ConfigMaps, DSPA secrets). This module
provides the same transform as a Client wrapper: reads served through it
return stripped copies unless the object matches a keep-predicate.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

from kubeflow_tpu_torch.api import annotations as ann
from kubeflow_tpu_torch.k8s.client import Client
from kubeflow_tpu_torch.controller.integrations import (
    CA_SOURCE_CONFIGMAPS,
    CA_TARGET_CONFIGMAP,
    RUNTIME_IMAGE_LABEL,
)

STRIPPED_MARK = "kubeflow.org/cache-stripped"

# Names whose payload the platform reconciler / webhook actually reads
# (reference main.go:104-118 keeps exactly these classes of object).
DEFAULT_KEEP_NAMES = frozenset(
    {name for name, _key in CA_SOURCE_CONFIGMAPS}
    | {CA_TARGET_CONFIGMAP, "pipeline-runtime-images"}
)
DEFAULT_KEEP_LABELS = (RUNTIME_IMAGE_LABEL, ann.FEAST_INTEGRATION_LABEL)


def default_keep(obj: dict) -> bool:
    meta = obj.get("metadata", {})
    if meta.get("name", "") in DEFAULT_KEEP_NAMES:
        return True
    labels = meta.get("labels", {})
    if any(label in labels for label in DEFAULT_KEEP_LABELS):
        return True
    # Elyra runtime-config secrets are read to build odh_dsp.json.
    if meta.get("name", "").startswith("ds-pipeline"):
        return True
    return False


def strip_payload(obj: dict, keep: Callable[[dict], bool] = default_keep) -> dict:
    """Strip data/binaryData/stringData from a ConfigMap/Secret copy."""
    if obj.get("kind") not in ("ConfigMap", "Secret") or keep(obj):
        return obj
    stripped = dict(obj)
    for field in ("data", "binaryData", "stringData"):
        stripped.pop(field, None)
    meta = dict(stripped.get("metadata", {}))
    annotations = dict(meta.get("annotations", {}))
    annotations[STRIPPED_MARK] = "true"
    meta["annotations"] = annotations
    stripped["metadata"] = meta
    return stripped


class TransformingClient:
    """Client wrapper applying cache transforms on reads.

    Writes pass through untouched — the transform models what the informer
    cache holds, not what the API server stores.
    """

    def __init__(self, inner: Client, keep: Callable[[dict], bool] = default_keep):
        self.inner = inner
        self.keep = keep

    def get(self, kind: str, name: str, namespace: str = "") -> dict:
        return strip_payload(self.inner.get(kind, name, namespace), self.keep)

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        labels: Optional[dict] = None,
        field_selector: Optional[dict] = None,
    ) -> Iterable[dict]:
        return [
            strip_payload(o, self.keep)
            for o in self.inner.list(kind, namespace, labels, field_selector)
        ]

    def create(self, obj: dict) -> dict:
        return self.inner.create(obj)

    def update(self, obj: dict) -> dict:
        return self.inner.update(obj)

    def update_status(self, obj: dict) -> dict:
        return self.inner.update_status(obj)

    def patch(self, kind: str, name: str, namespace: str, patch: dict) -> dict:
        return self.inner.patch(kind, name, namespace, patch)

    def delete(self, kind: str, name: str, namespace: str = "") -> None:
        return self.inner.delete(kind, name, namespace)

    def exists(self, kind: str, name: str, namespace: str = "") -> bool:
        return self.inner.exists(kind, name, namespace)
