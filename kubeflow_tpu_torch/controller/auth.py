"""kube-rbac-proxy backing resources (controller side of auth mode).

The port's own copy of ``kubeflow_tpu/controller/auth.py``, a rebuild of
reference components/odh-notebook-controller/controllers/
notebook_kube_rbac_auth.go: per-notebook ServiceAccount (:48-92), the
``{name}-kube-rbac-proxy`` Service on 8443 with OpenShift serving-cert
annotation (:95-159), the SubjectAccessReview ConfigMap (:180-282), and the
ClusterRoleBinding to ``system:auth-delegator`` (:287-342) — CRBs are
cluster-scoped so they cannot be owned and need manual cleanup (:346-368).
"""

from __future__ import annotations

import json

# proxy_service_name is shared with routes.py, so the HTTPRoute's
# backendRef always matches the Service, the long-name hashed fallback
# included.
from kubeflow_tpu_torch.api.names import proxy_service_name
from kubeflow_tpu_torch.api.notebook import Notebook
from kubeflow_tpu_torch.controller import reconcilehelper as helper
from kubeflow_tpu_torch.k8s.client import Client
from kubeflow_tpu_torch.k8s.errors import NotFoundError
from kubeflow_tpu_torch.webhook.auth_sidecar import (
    RBAC_PROXY_PORT,
    rbac_config_map_name,
    service_account_name,
    tls_secret_name,
)


def crb_name(nb: Notebook) -> str:
    return f"{nb.namespace}-{nb.name}-auth-delegator"


def new_service_account(nb: Notebook) -> dict:
    return {
        "apiVersion": "v1",
        "kind": "ServiceAccount",
        "metadata": {
            "name": service_account_name(nb.name),
            "namespace": nb.namespace,
            "labels": {"notebook-name": nb.name},
        },
    }


def new_proxy_service(nb: Notebook) -> dict:
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {
            "name": proxy_service_name(nb.name),
            "namespace": nb.namespace,
            "labels": {"notebook-name": nb.name},
            "annotations": {
                # OpenShift mints the TLS pair the sidecar serves with.
                "service.beta.openshift.io/serving-cert-secret-name": tls_secret_name(
                    nb.name
                ),
            },
        },
        "spec": {
            "type": "ClusterIP",
            "selector": {
                "statefulset": nb.name,
                "apps.kubernetes.io/pod-index": "0",
            },
            "ports": [
                {
                    "name": "https",
                    "port": RBAC_PROXY_PORT,
                    "targetPort": RBAC_PROXY_PORT,
                    "protocol": "TCP",
                }
            ],
        },
    }


def new_proxy_config_map(nb: Notebook) -> dict:
    """SubjectAccessReview config: access requires ``get`` on this Notebook
    (reference :180-282)."""
    config = {
        "authorization": {
            "resourceAttributes": {
                "apiGroup": "kubeflow.org",
                "resource": "notebooks",
                "verb": "get",
                "namespace": nb.namespace,
                "name": nb.name,
            }
        }
    }
    return {
        "apiVersion": "v1",
        "kind": "ConfigMap",
        "metadata": {
            "name": rbac_config_map_name(nb.name),
            "namespace": nb.namespace,
            "labels": {"notebook-name": nb.name},
        },
        "data": {"config-file.yaml": json.dumps(config, indent=2)},
    }


def new_auth_delegator_crb(nb: Notebook) -> dict:
    return {
        "apiVersion": "rbac.authorization.k8s.io/v1",
        "kind": "ClusterRoleBinding",
        "metadata": {
            "name": crb_name(nb),
            "labels": {
                "notebook-name": nb.name,
                "notebook-namespace": nb.namespace,
            },
        },
        "roleRef": {
            "apiGroup": "rbac.authorization.k8s.io",
            "kind": "ClusterRole",
            "name": "system:auth-delegator",
        },
        "subjects": [
            {
                "kind": "ServiceAccount",
                "name": service_account_name(nb.name),
                "namespace": nb.namespace,
            }
        ],
    }


def reconcile_auth_bundle(client: Client, nb: Notebook) -> None:
    """SA + Service + ConfigMap + CRB for auth mode (webhook injects the
    sidecar itself)."""
    helper.reconcile_child(client, nb.obj, new_service_account(nb))
    helper.reconcile_child(
        client, nb.obj, new_proxy_service(nb), helper.copy_service_fields
    )
    helper.reconcile_child(client, nb.obj, new_proxy_config_map(nb))
    desired_crb = new_auth_delegator_crb(nb)
    # Cluster-scoped: cannot carry a namespaced owner ref (reference :287).
    helper.reconcile_child(client, nb.obj, desired_crb, set_owner=False)


def cleanup_auth_bundle(client: Client, nb: Notebook) -> None:
    """Owned objects GC with the notebook; only the CRB needs manual
    deletion (reference :346-368). Used on both auth-mode-off and deletion."""
    try:
        client.delete("ClusterRoleBinding", crb_name(nb))
    except NotFoundError:
        pass


def cleanup_auth_mode_off(client: Client, nb: Notebook) -> None:
    """Mode switch auth→plain: remove the whole bundle (reference
    notebook_controller.go:479-497)."""
    cleanup_auth_bundle(client, nb)
    for kind, name in (
        ("ServiceAccount", service_account_name(nb.name)),
        ("Service", proxy_service_name(nb.name)),
        ("ConfigMap", rbac_config_map_name(nb.name)),
    ):
        try:
            client.delete(kind, name, nb.namespace)
        except NotFoundError:
            pass
