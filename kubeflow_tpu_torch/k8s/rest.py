"""Kind → REST mapping for the real API-server client.

The port's own copy of ``kubeflow_tpu/k8s/rest.py``: the same table, so
the two packages speak one REST dialect.

The discovery/RESTMapper role from client-go, reduced to a static table:
every kind the controllers touch, with its group/version/resource and
scope. The reference gets this from scheme registration + discovery
(reference components/notebook-controller/main.go:48-56 registers all
three Notebook versions; client-go's RESTMapper resolves the rest); a
static table keeps the client dependency-free and the mapping auditable.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional
from urllib.parse import quote, urlencode


@dataclass(frozen=True)
class KindInfo:
    group: str  # "" = core
    version: str
    resource: str  # plural, lowercase
    namespaced: bool = True

    @property
    def api_version(self) -> str:
        return self.version if not self.group else f"{self.group}/{self.version}"


# The served (hub) version is what the controllers read and write; the
# conversion webhook / CRD storage handles the rest (reference
# api/v1beta1/notebook_conversion.go:19's hub choice).
KINDS: dict[str, KindInfo] = {
    # kubeflow.org
    "Notebook": KindInfo("kubeflow.org", "v1beta1", "notebooks"),
    "SlicePool": KindInfo("kubeflow.org", "v1", "slicepools"),
    # core
    "Pod": KindInfo("", "v1", "pods"),
    "Service": KindInfo("", "v1", "services"),
    "ConfigMap": KindInfo("", "v1", "configmaps"),
    "Secret": KindInfo("", "v1", "secrets"),
    "ServiceAccount": KindInfo("", "v1", "serviceaccounts"),
    "Event": KindInfo("", "v1", "events"),
    "Namespace": KindInfo("", "v1", "namespaces", namespaced=False),
    "Node": KindInfo("", "v1", "nodes", namespaced=False),
    # apps
    "StatefulSet": KindInfo("apps", "v1", "statefulsets"),
    "Deployment": KindInfo("apps", "v1", "deployments"),
    # rbac
    "Role": KindInfo("rbac.authorization.k8s.io", "v1", "roles"),
    "RoleBinding": KindInfo("rbac.authorization.k8s.io", "v1", "rolebindings"),
    "ClusterRole": KindInfo(
        "rbac.authorization.k8s.io", "v1", "clusterroles", namespaced=False
    ),
    "ClusterRoleBinding": KindInfo(
        "rbac.authorization.k8s.io", "v1", "clusterrolebindings", namespaced=False
    ),
    # networking
    "NetworkPolicy": KindInfo("networking.k8s.io", "v1", "networkpolicies"),
    # gateway API
    "HTTPRoute": KindInfo("gateway.networking.k8s.io", "v1", "httproutes"),
    "Gateway": KindInfo("gateway.networking.k8s.io", "v1", "gateways"),
    "ReferenceGrant": KindInfo(
        "gateway.networking.k8s.io", "v1beta1", "referencegrants"
    ),
    # coordination (leader election)
    "Lease": KindInfo("coordination.k8s.io", "v1", "leases"),
    # scheduling
    "PriorityClass": KindInfo(
        "scheduling.k8s.io", "v1", "priorityclasses", namespaced=False
    ),
    # apiextensions
    "CustomResourceDefinition": KindInfo(
        "apiextensions.k8s.io", "v1", "customresourcedefinitions", namespaced=False
    ),
    # OpenShift-compatible platform APIs (the platform controller degrades
    # gracefully when these are absent — reference main.go:201-210).
    "APIServer": KindInfo("config.openshift.io", "v1", "apiservers", namespaced=False),
    "Proxy": KindInfo("config.openshift.io", "v1", "proxies", namespaced=False),
    "OAuthClient": KindInfo("oauth.openshift.io", "v1", "oauthclients", namespaced=False),
    "ImageStream": KindInfo("image.openshift.io", "v1", "imagestreams"),
    # Data Science Pipelines operator CR
    "DataSciencePipelinesApplication": KindInfo(
        "datasciencepipelinesapplications.opendatahub.io",
        "v1",
        "datasciencepipelinesapplications",
    ),
}


class UnknownKindError(KeyError):
    pass


def info_for(kind: str) -> KindInfo:
    try:
        return KINDS[kind]
    except KeyError:
        raise UnknownKindError(
            f"kind {kind!r} has no REST mapping; add it to kubeflow_tpu_torch.k8s.rest.KINDS"
        ) from None


def collection_path(kind: str, namespace: str = "") -> str:
    """/api/v1/namespaces/{ns}/pods or /apis/apps/v1/namespaces/{ns}/statefulsets."""
    info = info_for(kind)
    root = "/api/v1" if not info.group else f"/apis/{info.group}/{info.version}"
    if info.namespaced and namespace:
        return f"{root}/namespaces/{quote(namespace)}/{info.resource}"
    return f"{root}/{info.resource}"


def object_path(kind: str, name: str, namespace: str = "") -> str:
    return f"{collection_path(kind, namespace)}/{quote(name)}"


def status_path(kind: str, name: str, namespace: str = "") -> str:
    return f"{object_path(kind, name, namespace)}/status"


def label_selector_str(selector: Optional[dict]) -> str:
    if not selector:
        return ""
    return ",".join(f"{k}={v}" for k, v in sorted(selector.items()))


def list_query(
    label_selector: Optional[dict] = None,
    watch: bool = False,
    resource_version: str = "",
    allow_bookmarks: bool = False,
    timeout_seconds: int = 0,
    field_selector: Optional[dict] = None,
) -> str:
    """Query string for a list or watch request (empty or "?...")."""
    params: list[tuple[str, str]] = []
    sel = label_selector_str(label_selector)
    if sel:
        params.append(("labelSelector", sel))
    if field_selector:
        params.append((
            "fieldSelector",
            ",".join(f"{k}={v}" for k, v in sorted(field_selector.items())),
        ))
    if watch:
        params.append(("watch", "true"))
        if allow_bookmarks:
            params.append(("allowWatchBookmarks", "true"))
    if resource_version:
        params.append(("resourceVersion", resource_version))
    if timeout_seconds:
        params.append(("timeoutSeconds", str(timeout_seconds)))
    if not params:
        return ""
    return "?" + urlencode(params)
