"""Webhook-side mutations that mount platform resources into the notebook.

The port's own copy of ``kubeflow_tpu/webhook/mounts.py``: nothing here
depends on the device. Counterparts of the reference webhook's mount
pipeline (reference components/odh-notebook-controller/controllers/
notebook_mutating_webhook.go):

- CA trust bundle    — InjectCertConfig (:747-859): volume + SSL env block.
- Runtime images CM  — MountPipelineRuntimeImages (notebook_runtime.go:216-285).
- Elyra/DSPA secret  — MountElyraRuntimeConfigSecret (notebook_dspa_secret.go:403-477).
- Feast config       — label-gated mount/unmount (notebook_feast_config.go:25-146).

The corresponding *controller-side* sync (creating the ConfigMaps/Secrets in
the user namespace) lives in kubeflow_tpu_torch.controller.platform; each
mount skips gracefully when the source object does not exist yet (the
reference's "optional CR → skip" pattern).
"""

from __future__ import annotations

from kubeflow_tpu_torch.api import annotations as ann
from kubeflow_tpu_torch.api.names import (
    CA_BUNDLE_CONFIGMAP,
    ELYRA_SECRET_NAME,
    RUNTIME_IMAGES_CONFIGMAP,
)
from kubeflow_tpu_torch.api.notebook import Notebook
from kubeflow_tpu_torch.k8s.client import Client
from kubeflow_tpu_torch.k8s.errors import NotFoundError
from kubeflow_tpu_torch.webhook.gpu_env import remove_env, upsert_env

CA_MOUNT_PATH = "/etc/pki/tls/custom-certs"
CA_CERT_FILE = f"{CA_MOUNT_PATH}/ca-bundle.crt"

RUNTIME_IMAGES_MOUNT_PATH = "/opt/app-root/pipeline-runtimes"

ELYRA_MOUNT_PATH = "/opt/app-root/runtimes"

FEAST_MOUNT_PATH = "/opt/app-root/src/feast-config"

# Env vars pointed at the CA bundle (reference :747-859 sets the full set so
# pip/requests/git/SSL all trust the platform CA).
_CA_ENV_NAMES = {
    "PIP_CERT",
    "REQUESTS_CA_BUNDLE",
    "SSL_CERT_FILE",
    "GIT_SSL_CAINFO",
    "NODE_EXTRA_CA_CERTS",
}


def _mount_volume(nb: Notebook, volume: dict, mount: dict) -> bool:
    pod_spec = nb.pod_spec
    changed = False
    volumes = pod_spec.setdefault("volumes", [])
    existing = next(
        (i for i, v in enumerate(volumes) if v.get("name") == volume["name"]), None
    )
    if existing is None:
        volumes.append(volume)
        changed = True
    elif volumes[existing] != volume:
        volumes[existing] = volume
        changed = True
    container = nb.primary_container()
    if container is not None:
        mounts = container.setdefault("volumeMounts", [])
        existing = next(
            (i for i, m in enumerate(mounts) if m.get("name") == mount["name"]), None
        )
        if existing is None:
            mounts.append(mount)
            changed = True
        elif mounts[existing] != mount:
            mounts[existing] = mount
            changed = True
    return changed


def _unmount_volume(nb: Notebook, name: str) -> bool:
    pod_spec = nb.pod_spec
    changed = False
    volumes = pod_spec.get("volumes", [])
    kept = [v for v in volumes if v.get("name") != name]
    if len(kept) != len(volumes):
        pod_spec["volumes"] = kept
        changed = True
    container = nb.primary_container()
    if container is not None:
        mounts = container.get("volumeMounts", [])
        kept_m = [m for m in mounts if m.get("name") != name]
        if len(kept_m) != len(mounts):
            container["volumeMounts"] = kept_m
            changed = True
    return changed


# ---------------------------------------------------------------------------


def check_and_mount_ca_bundle(nb: Notebook, client: Client) -> bool:
    """Mount the namespace trust bundle if present (reference
    CheckAndMountCACertBundle :700-745); unmount + unset env when absent
    (UnsetNotebookCertConfig semantics, notebook_controller.go:668-733)."""
    try:
        cm = client.get("ConfigMap", CA_BUNDLE_CONFIGMAP, nb.namespace)
    except NotFoundError:
        changed = _unmount_volume(nb, "trusted-ca")
        container = nb.primary_container()
        if container is not None:
            changed |= remove_env(container, _CA_ENV_NAMES)
        return changed
    if not cm.get("data", {}).get("ca-bundle.crt"):
        return False
    changed = _mount_volume(
        nb,
        {
            "name": "trusted-ca",
            "configMap": {
                "name": CA_BUNDLE_CONFIGMAP,
                "items": [{"key": "ca-bundle.crt", "path": "ca-bundle.crt"}],
            },
        },
        {"name": "trusted-ca", "mountPath": CA_MOUNT_PATH, "readOnly": True},
    )
    container = nb.primary_container()
    if container is not None:
        changed |= upsert_env(
            container,
            [{"name": name, "value": CA_CERT_FILE} for name in sorted(_CA_ENV_NAMES)],
        )
    return changed


def mount_runtime_images(nb: Notebook, client: Client) -> bool:
    """Mount the synced runtime-images ConfigMap (reference :216-285)."""
    try:
        client.get("ConfigMap", RUNTIME_IMAGES_CONFIGMAP, nb.namespace)
    except NotFoundError:
        return _unmount_volume(nb, "runtime-images")
    return _mount_volume(
        nb,
        {"name": "runtime-images", "configMap": {"name": RUNTIME_IMAGES_CONFIGMAP}},
        {
            "name": "runtime-images",
            "mountPath": RUNTIME_IMAGES_MOUNT_PATH,
            "readOnly": True,
        },
    )


def mount_elyra_secret(nb: Notebook, client: Client) -> bool:
    """Mount the Elyra runtime config secret (reference :403-477)."""
    try:
        client.get("Secret", ELYRA_SECRET_NAME, nb.namespace)
    except NotFoundError:
        return _unmount_volume(nb, "elyra-dsp-config")
    return _mount_volume(
        nb,
        {"name": "elyra-dsp-config", "secret": {"secretName": ELYRA_SECRET_NAME}},
        {
            "name": "elyra-dsp-config",
            "mountPath": ELYRA_MOUNT_PATH,
            "readOnly": True,
        },
    )


def sync_feast_mount(nb: Notebook) -> bool:
    """Label-gated Feast config mount (reference notebook_feast_config.go:
    25-146 — webhook-only, the ConfigMap is user/operator-provided)."""
    enabled = (
        nb.obj.get("metadata", {}).get("labels", {}).get(ann.FEAST_INTEGRATION_LABEL)
        == "true"
    )
    volume_name = "feast-config"
    if not enabled:
        return _unmount_volume(nb, volume_name)
    return _mount_volume(
        nb,
        {"name": volume_name, "configMap": {"name": f"{nb.name}-feast-config"}},
        {"name": volume_name, "mountPath": FEAST_MOUNT_PATH, "readOnly": True},
    )
