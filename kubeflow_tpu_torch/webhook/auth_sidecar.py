"""kube-rbac-proxy sidecar injection (auth mode).

The port's own copy of ``kubeflow_tpu/webhook/auth_sidecar.py``, a
rebuild of the reference's InjectKubeRbacProxy (reference
components/odh-notebook-controller/controllers/
notebook_mutating_webhook.go:185-334): a TLS-terminating sidecar on port
8443 that authorizes each request via SubjectAccessReview (``get
notebooks.kubeflow.org/{name}``), with per-notebook ServiceAccount and
resource requests overridable through annotations
(parseAndValidateAuthSidecarResources :134-181).

On a GPU slice the sidecar rides **worker 0 only** in effect: the proxy
HTTPRoute targets the pod-0 Service, although the container is present on
every host pod (the template is shared: a few mCPU per host).
"""

from __future__ import annotations

import re

from kubeflow_tpu_torch.api import annotations as ann
from kubeflow_tpu_torch.api.names import RBAC_PROXY_PORT
from kubeflow_tpu_torch.api.notebook import Notebook

RBAC_PROXY_CONTAINER = "kube-rbac-proxy"

_QUANTITY_RE = re.compile(r"^\d+(\.\d+)?(m|k|Ki|Mi|Gi|Ti|M|G|T)?$")

_DEFAULT_RESOURCES = {
    "requests": {"cpu": "100m", "memory": "64Mi"},
    "limits": {"cpu": "100m", "memory": "64Mi"},
}


class InvalidSidecarResources(ValueError):
    pass


def parse_sidecar_resources(nb: Notebook) -> dict:
    """Resource overrides from annotations, validated (reference :134-181)."""
    resources = {
        "requests": dict(_DEFAULT_RESOURCES["requests"]),
        "limits": dict(_DEFAULT_RESOURCES["limits"]),
    }
    mapping = {
        ann.AUTH_SIDECAR_CPU_REQUEST: ("requests", "cpu"),
        ann.AUTH_SIDECAR_CPU_LIMIT: ("limits", "cpu"),
        ann.AUTH_SIDECAR_MEMORY_REQUEST: ("requests", "memory"),
        ann.AUTH_SIDECAR_MEMORY_LIMIT: ("limits", "memory"),
    }
    annotations = nb.obj.get("metadata", {}).get("annotations", {})
    for key, (section, resource) in mapping.items():
        value = annotations.get(key)
        if value is None:
            continue
        if not _QUANTITY_RE.match(value):
            raise InvalidSidecarResources(
                f"annotation {key}={value!r} is not a valid quantity"
            )
        resources[section][resource] = value
    return resources


def service_account_name(notebook_name: str) -> str:
    return f"{notebook_name}-auth-proxy"


def rbac_config_map_name(notebook_name: str) -> str:
    return f"{notebook_name}-kube-rbac-proxy-config"


def tls_secret_name(notebook_name: str) -> str:
    return f"{notebook_name}-tls"


def inject_kube_rbac_proxy(nb: Notebook, proxy_image: str) -> bool:
    """Add/refresh the sidecar, its volumes, and the dedicated SA."""
    resources = parse_sidecar_resources(nb)
    sidecar = {
        "name": RBAC_PROXY_CONTAINER,
        "image": proxy_image,
        "args": [
            f"--secure-listen-address=0.0.0.0:{RBAC_PROXY_PORT}",
            "--upstream=http://127.0.0.1:8888/",
            "--config-file=/etc/kube-rbac-proxy/config-file.yaml",
            "--tls-cert-file=/etc/tls/private/tls.crt",
            "--tls-private-key-file=/etc/tls/private/tls.key",
        ],
        "ports": [
            {"containerPort": RBAC_PROXY_PORT, "name": "https", "protocol": "TCP"}
        ],
        "resources": resources,
        "livenessProbe": _probe(),
        "readinessProbe": _probe(),
        "volumeMounts": [
            {"name": "kube-rbac-proxy-config", "mountPath": "/etc/kube-rbac-proxy"},
            {"name": "kube-rbac-proxy-tls", "mountPath": "/etc/tls/private"},
        ],
    }
    pod_spec = nb.pod_spec
    changed = False

    containers = pod_spec.setdefault("containers", [])
    existing = next(
        (i for i, c in enumerate(containers) if c.get("name") == RBAC_PROXY_CONTAINER),
        None,
    )
    if existing is None:
        containers.append(sidecar)
        changed = True
    elif containers[existing] != sidecar:
        containers[existing] = sidecar
        changed = True

    volumes = pod_spec.setdefault("volumes", [])
    for vol in (
        {
            "name": "kube-rbac-proxy-config",
            "configMap": {"name": rbac_config_map_name(nb.name)},
        },
        {
            "name": "kube-rbac-proxy-tls",
            "secret": {"secretName": tls_secret_name(nb.name)},
        },
    ):
        if not any(v.get("name") == vol["name"] for v in volumes):
            volumes.append(vol)
            changed = True

    # Dedicated ServiceAccount so the SubjectAccessReview delegation chain
    # is per-notebook (reference :332).
    sa = service_account_name(nb.name)
    if pod_spec.get("serviceAccountName") != sa:
        pod_spec["serviceAccountName"] = sa
        changed = True
    return changed


def remove_kube_rbac_proxy(nb: Notebook) -> bool:
    """Strip the sidecar when auth is turned off (mode switching)."""
    pod_spec = nb.pod_spec
    changed = False
    containers = pod_spec.get("containers", [])
    kept = [c for c in containers if c.get("name") != RBAC_PROXY_CONTAINER]
    if len(kept) != len(containers):
        pod_spec["containers"] = kept
        changed = True
    volumes = pod_spec.get("volumes", [])
    kept_v = [
        v
        for v in volumes
        if v.get("name") not in ("kube-rbac-proxy-config", "kube-rbac-proxy-tls")
    ]
    if len(kept_v) != len(volumes):
        pod_spec["volumes"] = kept_v
        changed = True
    if pod_spec.get("serviceAccountName") == service_account_name(nb.name):
        del pod_spec["serviceAccountName"]
        changed = True
    return changed


def _probe() -> dict:
    return {
        "httpGet": {"path": "/healthz", "port": RBAC_PROXY_PORT, "scheme": "HTTPS"},
        "initialDelaySeconds": 5,
        "periodSeconds": 10,
    }
