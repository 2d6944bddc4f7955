"""Platform integrations: CA bundles, runtime images, Elyra/DSPA, pipeline
RBAC, MLflow, legacy OAuth cleanup.

The port's own copy of ``kubeflow_tpu/controller/integrations.py``. These
are the reference's mechanically-independent sub-reconcilers, each
following its "optional CR → skip gracefully" pattern (reference
notebook_dspa_secret.go:49-66). File-level reference anchors given per
function.
"""

from __future__ import annotations

import base64
import json
import logging
import re
from typing import Optional

from kubeflow_tpu_torch.api import annotations as ann
from kubeflow_tpu_torch.api.names import (
    CA_BUNDLE_CONFIGMAP,
    ELYRA_SECRET_NAME,
    MANAGED_BY_LABEL,
    MANAGED_BY_VALUE,
    RUNTIME_IMAGES_CONFIGMAP,
)
from kubeflow_tpu_torch.api.notebook import Notebook
from kubeflow_tpu_torch.controller import reconcilehelper as helper
from kubeflow_tpu_torch.k8s import objects as obj_util
from kubeflow_tpu_torch.k8s.client import Client, retry_on_conflict
from kubeflow_tpu_torch.k8s.errors import NotFoundError

log = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# CA trust bundle (reference notebook_controller.go CreateNotebookCertConfigMap
# :533-635: merges up to 3 source ConfigMaps with PEM validation into the
# per-namespace workbench-trusted-ca-bundle)

CA_SOURCE_CONFIGMAPS = (
    ("odh-trusted-ca-bundle", "ca-bundle.crt"),
    ("odh-trusted-ca-bundle", "odh-ca-bundle.crt"),
    ("kube-root-ca.crt", "ca.crt"),
)
CA_TARGET_CONFIGMAP = CA_BUNDLE_CONFIGMAP

_PEM_BLOCK_RE = re.compile(
    r"-----BEGIN CERTIFICATE-----[A-Za-z0-9+/=\s]+-----END CERTIFICATE-----"
)


def validate_pem_bundle(text: str) -> list[str]:
    """Extract well-formed PEM certificate blocks; malformed content is
    dropped rather than poisoning the merged bundle (reference :583-607)."""
    return _PEM_BLOCK_RE.findall(text or "")


def reconcile_ca_bundle(
    client: Client, nb: Notebook, controller_namespace: str
) -> None:
    blocks: list[str] = []
    for cm_name, key in CA_SOURCE_CONFIGMAPS:
        for source_ns in (controller_namespace, nb.namespace):
            try:
                cm = client.get("ConfigMap", cm_name, source_ns)
            except NotFoundError:
                continue
            blocks.extend(validate_pem_bundle(cm.get("data", {}).get(key, "")))
            break
    # Dedup, preserve order.
    seen: set[str] = set()
    unique = [b for b in blocks if not (b in seen or seen.add(b))]
    if not unique:
        # No sources → remove the target so the webhook unmounts it
        # (reference UnsetNotebookCertConfig :668-733).
        try:
            client.delete("ConfigMap", CA_TARGET_CONFIGMAP, nb.namespace)
        except NotFoundError:
            pass
        return
    desired = {
        "apiVersion": "v1",
        "kind": "ConfigMap",
        "metadata": {
            "name": CA_TARGET_CONFIGMAP,
            "namespace": nb.namespace,
            "labels": {MANAGED_BY_LABEL: MANAGED_BY_VALUE},
        },
        "data": {"ca-bundle.crt": "\n".join(unique) + "\n"},
    }
    # Namespace-shared: not owned by one notebook.
    helper.reconcile_child(client, nb.obj, desired, set_owner=False)


# ---------------------------------------------------------------------------
# Runtime images (reference notebook_runtime.go SyncRuntimeImagesConfigMap
# :43-152: ImageStreams labeled opendatahub.io/runtime-image in the
# controller ns → per-user-ns ConfigMap; key sanitization :174-182)

RUNTIME_IMAGE_LABEL = ann.RUNTIME_IMAGE_LABEL


def format_key_name(display_name: str) -> str:
    """Reference formatKeyName :174-182: displayName → ConfigMap key."""
    key = re.sub(r"[^A-Za-z0-9._-]", "-", display_name.strip().lower())
    return key.strip("-._") or "runtime-image"


def sync_runtime_images_config_map(
    client: Client, nb: Notebook, controller_namespace: str
) -> None:
    streams = client.list(
        "ImageStream", controller_namespace, {RUNTIME_IMAGE_LABEL: "true"}
    )
    data = {}
    for stream in streams:
        meta = stream.get("metadata", {})
        display = meta.get("annotations", {}).get(
            ann.RUNTIME_IMAGE_NAME, meta.get("name", "")
        )
        image_ref = ""
        for tag in stream.get("status", {}).get("tags", []):
            items = tag.get("items", [])
            if items:
                image_ref = items[0].get("dockerImageReference", "")
                break
        if not image_ref:
            continue
        data[format_key_name(display) + ".json"] = json.dumps(
            {"display_name": display, "metadata": {"image_name": image_ref}}
        )
    if not data:
        # Sources gone → delete the synced CM (if it is ours) so the
        # webhook unmounts stale runtime definitions.
        try:
            existing = client.get("ConfigMap", RUNTIME_IMAGES_CONFIGMAP, nb.namespace)
            if (
                existing.get("metadata", {}).get("labels", {}).get(MANAGED_BY_LABEL)
                == MANAGED_BY_VALUE
            ):
                client.delete("ConfigMap", RUNTIME_IMAGES_CONFIGMAP, nb.namespace)
        except NotFoundError:
            pass
        return
    desired = {
        "apiVersion": "v1",
        "kind": "ConfigMap",
        "metadata": {
            "name": RUNTIME_IMAGES_CONFIGMAP,
            "namespace": nb.namespace,
            "labels": {MANAGED_BY_LABEL: MANAGED_BY_VALUE},
        },
        "data": data,
    }
    helper.reconcile_child(client, nb.obj, desired, set_owner=False)


# ---------------------------------------------------------------------------
# Elyra / DSPA secret (reference notebook_dspa_secret.go
# SyncElyraRuntimeConfigSecret :305-399, extractElyraRuntimeConfigInfo
# :189-298, getHostnameForPublicEndpoint :106-148)


def _decode_secret_value(data: dict, key: str) -> str:
    """Secret.data values are base64 on the wire; Elyra wants plaintext."""
    raw = data.get(key, "")
    if not raw:
        return ""
    try:
        return base64.b64decode(raw).decode()
    except (ValueError, UnicodeDecodeError):
        return ""


def sync_elyra_runtime_config(
    client: Client, nb: Notebook, gateway_hostname: str = ""
) -> None:
    dspas = client.list("DataSciencePipelinesApplication", nb.namespace)
    if not dspas:
        return  # optional CR absent → skip gracefully (reference :49-66)
    dspa = dspas[0]
    dspa_name = dspa.get("metadata", {}).get("name", "dspa")
    object_storage = (
        dspa.get("spec", {}).get("objectStorage", {}).get("externalStorage", {})
    )
    s3_secret_name = (
        object_storage.get("s3CredentialsSecret", {}).get("secretName", "")
    )
    access_key = secret_key = ""
    if s3_secret_name:
        try:
            s3 = client.get("Secret", s3_secret_name, nb.namespace)
            access_key = _decode_secret_value(s3.get("data", {}), "AWS_ACCESS_KEY_ID")
            secret_key = _decode_secret_value(
                s3.get("data", {}), "AWS_SECRET_ACCESS_KEY"
            )
        except NotFoundError:
            pass
    api_endpoint = (
        f"https://{gateway_hostname}/pipelines/{nb.namespace}/{dspa_name}"
        if gateway_hostname
        else f"https://ds-pipeline-{dspa_name}.{nb.namespace}.svc:8443"
    )
    runtime_config = {
        "display_name": f"Data Science Pipeline: {dspa_name}",
        "schema_name": "kfp",
        "metadata": {
            "api_endpoint": api_endpoint,
            "engine": "Argo",
            "auth_type": "KUBERNETES_SERVICE_ACCOUNT_TOKEN",
            "cos_endpoint": object_storage.get("host", ""),
            "cos_bucket": object_storage.get("bucket", ""),
            "cos_username": access_key,
            "cos_password": secret_key,
            "runtime_type": "KUBEFLOW_PIPELINES",
        },
    }
    desired = {
        "apiVersion": "v1",
        "kind": "Secret",
        "metadata": {
            "name": ELYRA_SECRET_NAME,
            "namespace": nb.namespace,
            "labels": {MANAGED_BY_LABEL: MANAGED_BY_VALUE},
        },
        "stringData": {"odh_dsp.json": json.dumps(runtime_config)},
    }
    # Owned by the DSPA CR, not the notebook (reference :354-363): the
    # secret outlives notebooks and dies with the pipeline application.
    def write():
        try:
            existing = client.get("Secret", ELYRA_SECRET_NAME, nb.namespace)
            if helper.copy_generic_fields(desired, existing):
                client.update(existing)
        except NotFoundError:
            obj_util.set_controller_reference(dspa, desired)
            client.create(desired)

    retry_on_conflict(write)


# ---------------------------------------------------------------------------
# Pipeline RBAC (reference notebook_rbac.go :88-154)

PIPELINE_ROLE = "ds-pipeline-user-access-dspa"


def reconcile_pipeline_rbac(client: Client, nb: Notebook) -> None:
    try:
        client.get("Role", PIPELINE_ROLE, nb.namespace)
    except NotFoundError:
        return  # Role absent → skip (reference behavior)
    desired = {
        "apiVersion": "rbac.authorization.k8s.io/v1",
        "kind": "RoleBinding",
        "metadata": {
            "name": f"elyra-pipelines-{nb.name}",
            "namespace": nb.namespace,
            "labels": {"notebook-name": nb.name},
        },
        "roleRef": {
            "apiGroup": "rbac.authorization.k8s.io",
            "kind": "Role",
            "name": PIPELINE_ROLE,
        },
        "subjects": [
            {"kind": "ServiceAccount", "name": nb.name, "namespace": nb.namespace}
        ],
    }
    helper.reconcile_child(client, nb.obj, desired)


# ---------------------------------------------------------------------------
# MLflow RoleBinding (reference notebook_mlflow.go :236-270: requeue until
# the operator's ClusterRole exists)

MLFLOW_CLUSTER_ROLE = "mlflow-operator-mlflow-integration"


def reconcile_mlflow_rbac(client: Client, nb: Notebook) -> Optional[float]:
    """Returns a requeue-after in seconds while the ClusterRole is missing."""
    if not nb.annotations.get(ann.MLFLOW_INSTANCE):
        return None
    try:
        client.get("ClusterRole", MLFLOW_CLUSTER_ROLE)
    except NotFoundError:
        return 30.0  # reference RequeueAfter 30s (:236-270)
    desired = {
        "apiVersion": "rbac.authorization.k8s.io/v1",
        "kind": "RoleBinding",
        "metadata": {
            "name": f"mlflow-{nb.name}",
            "namespace": nb.namespace,
            "labels": {"notebook-name": nb.name},
        },
        "roleRef": {
            "apiGroup": "rbac.authorization.k8s.io",
            "kind": "ClusterRole",
            "name": MLFLOW_CLUSTER_ROLE,
        },
        "subjects": [
            {"kind": "ServiceAccount", "name": nb.name, "namespace": nb.namespace}
        ],
    }
    helper.reconcile_child(client, nb.obj, desired)
    return None


# ---------------------------------------------------------------------------
# Legacy OAuth cleanup (reference notebook_oauth.go :29-96: pre-3.0 releases
# created one OAuthClient CR per notebook; deletion must reap them)


def cleanup_legacy_oauth_client(client: Client, nb: Notebook) -> None:
    name = f"{nb.name}-{nb.namespace}-oauth-client"
    try:
        client.delete("OAuthClient", name)
    except NotFoundError:
        pass
