"""Child-object names and in-pod ports: the wire contract between the
StatefulSet, its Services and the env the webhook writes.

The port's copy of ``kubeflow_tpu/api/names.py``. Pods resolve each other
by these DNS names, so every name agrees with the JAX package's byte for
byte, the hashed fallback for long names included.
"""

from __future__ import annotations

import hashlib

NOTEBOOK_PORT = 8888
RBAC_PROXY_PORT = 8443  # the kube-rbac-proxy sidecar's TLS port
# The coordinator port the env names: the JAX package's
# jax.distributed port, which the port's torch.distributed rendezvous
# listens on in its place.
JAX_COORDINATOR_PORT = 8476
MEGASCALE_PORT = 8081  # the multislice coordinator port


def derived_name(base: str, suffix: str = "", limit: int = 63) -> str:
    """``{base}{suffix}`` when it fits ``limit``, else a deterministic
    hashed fallback: truncated base + 8-hex sha1(base) + suffix.

    Every child-object name derived from a Notebook name goes through
    this, so a long Notebook name degrades the same way everywhere
    (StatefulSets at 52 characters, Services and DNS labels at 63) and
    each object can still be found by name."""
    candidate = f"{base}{suffix}"
    if len(candidate) <= limit:
        return candidate
    digest = hashlib.sha1(base.encode()).hexdigest()[:8]
    keep = limit - len(suffix) - len(digest) - 1
    return f"{base[:keep]}-{digest}{suffix}"


def routing_service_name(notebook_name: str) -> str:
    """The per-notebook routing Service."""
    return derived_name(notebook_name, "", 63)


def proxy_service_name(notebook_name: str) -> str:
    """The kube-rbac-proxy Service, which the auth-mode HTTPRoute targets."""
    return derived_name(notebook_name, "-kube-rbac-proxy", 63)


# Objects the platform reconciler writes into the user's namespace.
CA_BUNDLE_CONFIGMAP = "workbench-trusted-ca-bundle"
RUNTIME_IMAGES_CONFIGMAP = "pipeline-runtime-images"
ELYRA_SECRET_NAME = "ds-pipeline-config"
MANAGED_BY_LABEL = "opendatahub.io/managed-by"
MANAGED_BY_VALUE = "workbenches"
