"""Gateway-API routing: HTTPRoutes in the central namespace + ReferenceGrants.

The port's own copy of ``kubeflow_tpu/controller/routes.py``, a rebuild of
the reference's route layer (reference
components/odh-notebook-controller/controllers/notebook_route.go:51-325 and
notebook_referencegrant.go:39-184):

- The HTTPRoute ``nb-{ns}-{name}`` lives in the **controller (central)
  namespace** and carries a cross-namespace backendRef to the notebook's
  Service. Cross-namespace owner references are impossible, so routes are
  found by labels and cleaned up by the deletion finalizer (:173-193).
- Each user namespace gets one ``notebook-httproute-access`` ReferenceGrant
  permitting central-namespace HTTPRoutes → Services; it is deleted only
  when the namespace's last notebook goes away (:130-162).
- Auth mode swaps the backend to the kube-rbac-proxy service on 8443; the
  conflicting other-mode route is removed on mode switches (:270-325).

On a GPU slice the route always lands on pod 0 (Jupyter runs on worker 0).
"""

from __future__ import annotations

from dataclasses import dataclass

from kubeflow_tpu_torch.api.names import (
    proxy_service_name,
    routing_service_name,
)
from kubeflow_tpu_torch.api.notebook import Notebook
from kubeflow_tpu_torch.controller import reconcilehelper as helper
from kubeflow_tpu_torch.k8s.client import Client
from kubeflow_tpu_torch.k8s.errors import NotFoundError

HTTPROUTE_API = "gateway.networking.k8s.io/v1"
REFERENCEGRANT_API = "gateway.networking.k8s.io/v1beta1"
REFERENCE_GRANT_NAME = "notebook-httproute-access"

NOTEBOOK_NS_LABEL = "notebook-namespace"
NOTEBOOK_NAME_ROUTE_LABEL = "notebook-name"
ROUTE_MODE_LABEL = "notebook-route-mode"  # plain | auth


@dataclass
class RouteConfig:
    controller_namespace: str = "opendatahub"
    gateway_name: str = "data-science-gateway"
    gateway_namespace: str = "openshift-ingress"

    @classmethod
    def from_env(cls, env: dict) -> "RouteConfig":
        return cls(
            controller_namespace=env.get("K8S_NAMESPACE", "opendatahub"),
            gateway_name=env.get("NOTEBOOK_GATEWAY_NAME", "data-science-gateway"),
            gateway_namespace=env.get("NOTEBOOK_GATEWAY_NAMESPACE", "openshift-ingress"),
        )


def route_name(nb: Notebook) -> str:
    return f"nb-{nb.namespace}-{nb.name}"


def new_httproute(nb: Notebook, cfg: RouteConfig, auth: bool) -> dict:
    """Build the HTTPRoute (reference NewNotebookHTTPRoute :51-132)."""
    if auth:
        backend = {
            "name": proxy_service_name(nb.name),
            "namespace": nb.namespace,
            "port": 8443,
        }
    else:
        backend = {
            "name": routing_service_name(nb.name),
            "namespace": nb.namespace,
            "port": 80,
        }
    return {
        "apiVersion": HTTPROUTE_API,
        "kind": "HTTPRoute",
        "metadata": {
            "name": route_name(nb),
            "namespace": cfg.controller_namespace,
            "labels": {
                NOTEBOOK_NAME_ROUTE_LABEL: nb.name,
                NOTEBOOK_NS_LABEL: nb.namespace,
                ROUTE_MODE_LABEL: "auth" if auth else "plain",
            },
        },
        "spec": {
            "parentRefs": [
                {"name": cfg.gateway_name, "namespace": cfg.gateway_namespace}
            ],
            "rules": [
                {
                    "matches": [
                        {
                            "path": {
                                "type": "PathPrefix",
                                "value": f"/notebook/{nb.namespace}/{nb.name}",
                            }
                        }
                    ],
                    "backendRefs": [backend],
                }
            ],
        },
    }


def reconcile_httproute(client: Client, nb: Notebook, cfg: RouteConfig, auth: bool) -> None:
    desired = new_httproute(nb, cfg, auth)
    # Cross-namespace: no owner reference possible (reference :173-193).
    helper.reconcile_child(client, nb.obj, desired, set_owner=False)


def ensure_conflicting_route_absent(
    client: Client, nb: Notebook, cfg: RouteConfig, auth: bool
) -> None:
    """On auth-mode switches the old-mode route must go (reference :270-325).
    Route names collide by design, so a mode mismatch means delete+recreate."""
    try:
        existing = client.get("HTTPRoute", route_name(nb), cfg.controller_namespace)
    except NotFoundError:
        return
    mode = existing.get("metadata", {}).get("labels", {}).get(ROUTE_MODE_LABEL)
    want = "auth" if auth else "plain"
    if mode != want:
        client.delete("HTTPRoute", route_name(nb), cfg.controller_namespace)


def delete_httproute(client: Client, nb: Notebook, cfg: RouteConfig) -> None:
    """Finalizer-driven cleanup (reference DeleteHTTPRouteForNotebook :230-266)."""
    try:
        client.delete("HTTPRoute", route_name(nb), cfg.controller_namespace)
    except NotFoundError:
        pass


# ---------------------------------------------------------------------------
# ReferenceGrant


def new_reference_grant(namespace: str, cfg: RouteConfig) -> dict:
    """Reference NewNotebookReferenceGrant :39-69."""
    return {
        "apiVersion": REFERENCEGRANT_API,
        "kind": "ReferenceGrant",
        "metadata": {"name": REFERENCE_GRANT_NAME, "namespace": namespace},
        "spec": {
            "from": [
                {
                    "group": "gateway.networking.k8s.io",
                    "kind": "HTTPRoute",
                    "namespace": cfg.controller_namespace,
                }
            ],
            "to": [{"group": "", "kind": "Service"}],
        },
    }


def reconcile_reference_grant(client: Client, nb: Notebook, cfg: RouteConfig) -> None:
    desired = new_reference_grant(nb.namespace, cfg)
    # Namespace-scoped shared resource: not owned by any single notebook.
    helper.reconcile_child(client, nb.obj, desired, set_owner=False)


def delete_reference_grant_if_last_notebook(
    client: Client, nb: Notebook, cfg: RouteConfig
) -> None:
    """Reference DeleteReferenceGrantIfLastNotebook :130-162."""
    for other in client.list("Notebook", nb.namespace):
        if other.get("metadata", {}).get("name") == nb.name:
            continue
        if "deletionTimestamp" not in other.get("metadata", {}):
            return  # another live notebook still needs the grant
    try:
        client.delete("ReferenceGrant", REFERENCE_GRANT_NAME, nb.namespace)
    except NotFoundError:
        pass
