"""A Notebook on GPU nodes as an indexed StatefulSet and two Services.

The counterpart of the pure spec generators of
``kubeflow_tpu/controller/notebook.py``. A notebook is N pods, one a host:

- no ``spec.gpu``: a 1-replica StatefulSet behind the routing Service;
- ``spec.gpu``: an indexed StatefulSet with ``replicas`` = the slice's
  hosts, ``podManagementPolicy: Parallel`` (a partial slice is useless,
  and its process group would wait), ``nvidia.com/gpu`` limits and
  requests of the host's cards on the primary container, the node type's
  nodeSelector (and ``cloud.google.com/gke-spot`` for spot), an
  ``nvidia.com/gpu`` toleration, and a headless Service that gives every
  host a stable DNS name;
- the stop annotation scales the whole slice to 0;
- a multislice notebook has one StatefulSet a slice, whose pods carry
  their slice-local index, with the ``MEGASCALE_*`` and ``JAX_*`` env that
  spans every slice.

Everything but the resource, the nodeSelector and the toleration is the
JAX package's: labels, the annotation filter, ports, ``NB_PREFIX``,
``fsGroup``. The reconciler loop, status mirroring and the culler need the
cluster layer and are not here.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional

from kubeflow_tpu_torch.api import annotations as ann
from kubeflow_tpu_torch.api.names import (
    JAX_COORDINATOR_PORT,
    MEGASCALE_PORT,
    NOTEBOOK_PORT,
    derived_name,
    routing_service_name,
)
from kubeflow_tpu_torch.api.notebook import MAX_NAME_LENGTH, Notebook
from kubeflow_tpu_torch.gpu.topology import SliceTopology
from kubeflow_tpu_torch.runtime import env as envc
from kubeflow_tpu_torch.webhook.gpu_env import POD_INDEX_LABEL, upsert_env

NOTEBOOK_PORT_NAME = "notebook-port"
GPU_RESOURCE = "nvidia.com/gpu"

# Annotations never copied onto pod templates: kubectl's and the
# controller-owned lifecycle keys, whose churn would roll the StatefulSet.
_TEMPLATE_ANNOTATION_SKIP = {
    "kubectl.kubernetes.io/last-applied-configuration",
    ann.STOP,
    ann.RESTART,
    ann.LAST_ACTIVITY,
    ann.LAST_ACTIVITY_CHECK,
    ann.UPDATE_PENDING,
    ann.TPU_SLICE_INTERRUPTED,
    ann.TPU_RECOVERY_STARTED,
    ann.TPU_RECOVERY_ESCALATIONS,
    ann.TPU_RECOVERY_LAST_ESCALATION,
    ann.TPU_LAST_INTERRUPTION_DURATION,
}


@dataclass
class ControllerConfig:
    """The controller settings the generators read."""

    add_fsgroup: bool = True
    cluster_domain: str = "cluster.local"
    default_working_dir: str = "/home/jovyan"


def headless_service_name(notebook_name: str) -> str:
    # Service names get the full 63-character DNS label budget.
    return derived_name(notebook_name, "-hosts", 63)


def slice_sts_name(notebook_name: str, slice_id: int) -> str:
    """StatefulSet name of one slice: slice 0 keeps the bare notebook
    name whenever it fits, later ones add ``-s{j}``; names over the
    52-character budget take the hashed fallback."""
    suffix = "" if slice_id == 0 else f"-s{slice_id}"
    return derived_name(notebook_name, suffix, MAX_NAME_LENGTH)


def slice_sts_names(notebook_name: str, slice_count: int) -> list[str]:
    return [slice_sts_name(notebook_name, j) for j in range(slice_count)]


def generate_statefulset(
    nb: Notebook,
    slice_topo: Optional[SliceTopology],
    config: ControllerConfig,
    slice_id: int = 0,
    slice_count: int = 1,
) -> dict:
    """Notebook → the StatefulSet of slice ``slice_id``. Slice-varying
    env (``TPU_WORKER_HOSTNAMES``, ``MEGASCALE_*``) is set here on a
    multislice notebook; the rest comes from the webhook."""
    hosts = slice_topo.hosts if slice_topo else 1
    replicas = 0 if nb.stopped else hosts
    sts_name = slice_sts_name(nb.name, slice_id)

    template_labels = {
        "statefulset": sts_name,
        ann.NOTEBOOK_NAME_LABEL: nb.name,
    }
    for key, value in nb.labels.items():
        template_labels.setdefault(key, value)
    template_annotations = {
        k: v
        for k, v in nb.annotations.items()
        if k not in _TEMPLATE_ANNOTATION_SKIP
    }

    pod_spec = copy.deepcopy(nb.pod_spec)
    containers = pod_spec.setdefault("containers", [])
    for container in containers:
        if container.get("name") == nb.name:
            _apply_container_defaults(container, nb, config)
            if slice_topo is not None:
                resources = container.setdefault("resources", {})
                cards = str(slice_topo.chips_per_host)
                resources.setdefault("limits", {})[GPU_RESOURCE] = cards
                resources.setdefault("requests", {})[GPU_RESOURCE] = cards
                if slice_count > 1:
                    _apply_multislice_env(
                        container, nb, slice_topo, config, slice_id,
                        slice_count)
            break

    if config.add_fsgroup:
        pod_spec.setdefault("securityContext", {}).setdefault("fsGroup", 100)

    if slice_topo is not None:
        selector = pod_spec.setdefault("nodeSelector", {})
        selector.update(slice_topo.node_selector())
        gpu = nb.gpu
        if gpu is not None and gpu.spot:
            selector["cloud.google.com/gke-spot"] = "true"
        tolerations = pod_spec.setdefault("tolerations", [])
        if not any(t.get("key") == GPU_RESOURCE for t in tolerations):
            tolerations.append(
                {"key": GPU_RESOURCE, "operator": "Exists",
                 "effect": "NoSchedule"})

    sts = {
        "apiVersion": "apps/v1",
        "kind": "StatefulSet",
        "metadata": {
            "name": sts_name,
            "namespace": nb.namespace,
            "labels": dict(template_labels),
        },
        "spec": {
            "replicas": replicas,
            # Keyed on the per-slice name: two slices' StatefulSets never
            # adopt each other's pods.
            "selector": {"matchLabels": {"statefulset": sts_name}},
            "serviceName": headless_service_name(nb.name)
            if slice_topo is not None
            else routing_service_name(nb.name),
            "template": {
                "metadata": {
                    "labels": template_labels,
                    "annotations": template_annotations,
                },
                "spec": pod_spec,
            },
        },
    }
    if slice_topo is not None:
        # Every host comes up at once; OrderedReady would serialize them.
        sts["spec"]["podManagementPolicy"] = "Parallel"
    return sts


def _apply_multislice_env(
    container: dict,
    nb: Notebook,
    slice_topo: SliceTopology,
    config: ControllerConfig,
    slice_id: int,
    slice_count: int,
) -> None:
    """Slice-varying env of a multislice notebook, over the webhook's
    single-slice values: this slice's hosts, the hosts a slice, the slice
    count and id, and host 0 of slice 0 as both coordinators; the process
    count spans every host of every slice."""
    headless = headless_service_name(nb.name)
    sts_name = slice_sts_name(nb.name, slice_id)
    hostnames = slice_topo.worker_hostnames(
        sts_name, headless, nb.namespace, config.cluster_domain
    )
    head = (
        f"{slice_sts_name(nb.name, 0)}-0.{headless}."
        f"{nb.namespace}.svc.{config.cluster_domain}"
    )
    upsert_env(
        container,
        [
            {"name": envc.TPU_WORKER_HOSTNAMES, "value": ",".join(hostnames)},
            {"name": envc.TPU_HOSTS_PER_SLICE, "value": str(slice_topo.hosts)},
            {"name": envc.MEGASCALE_NUM_SLICES, "value": str(slice_count)},
            {"name": envc.MEGASCALE_SLICE_ID, "value": str(slice_id)},
            {
                "name": envc.MEGASCALE_COORDINATOR_ADDRESS,
                "value": f"{head}:{MEGASCALE_PORT}",
            },
            {
                "name": envc.JAX_COORDINATOR_ADDRESS,
                "value": f"{head}:{JAX_COORDINATOR_PORT}",
            },
            {
                "name": envc.JAX_NUM_PROCESSES,
                "value": str(slice_topo.hosts * slice_count),
            },
        ],
    )


def _apply_container_defaults(
    container: dict, nb: Notebook, config: ControllerConfig
) -> None:
    """The working directory, the notebook port and ``NB_PREFIX``."""
    container.setdefault("workingDir", config.default_working_dir)
    ports = container.setdefault("ports", [])
    if not any(p.get("containerPort") == NOTEBOOK_PORT for p in ports):
        ports.append(
            {"containerPort": NOTEBOOK_PORT, "name": NOTEBOOK_PORT_NAME,
             "protocol": "TCP"})
    env = container.setdefault("env", [])
    if not any(e.get("name") == "NB_PREFIX" for e in env):
        env.append(
            {"name": "NB_PREFIX", "value": f"/notebook/{nb.namespace}/{nb.name}"}
        )


def generate_service(nb: Notebook) -> dict:
    """Routing Service: port 80 → 8888 on pod 0 of slice 0, where the
    notebook server runs."""
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {
            "name": routing_service_name(nb.name),
            "namespace": nb.namespace,
            "labels": {ann.NOTEBOOK_NAME_LABEL: nb.name},
        },
        "spec": {
            "type": "ClusterIP",
            "selector": {
                "statefulset": slice_sts_name(nb.name, 0),
                POD_INDEX_LABEL: "0",
            },
            "ports": [
                {
                    "name": derived_name("http-" + nb.name, "", 63),
                    "port": 80,
                    "targetPort": NOTEBOOK_PORT,
                    "protocol": "TCP",
                }
            ],
        },
    }


def generate_headless_service(nb: Notebook, slice_topo: SliceTopology) -> dict:
    """Headless Service giving every slice host a stable DNS name, the
    backbone of TPU_WORKER_HOSTNAMES and the rendezvous. It selects by the
    notebook label, so every slice's pods share one DNS space."""
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {
            "name": headless_service_name(nb.name),
            "namespace": nb.namespace,
            "labels": {ann.NOTEBOOK_NAME_LABEL: nb.name},
        },
        "spec": {
            "clusterIP": "None",
            "selector": {ann.NOTEBOOK_NAME_LABEL: nb.name},
            "publishNotReadyAddresses": True,  # resolvable while forming
            "ports": [
                {"name": "jax-coordinator", "port": JAX_COORDINATOR_PORT,
                 "protocol": "TCP"},
                {"name": "notebook", "port": NOTEBOOK_PORT, "protocol": "TCP"},
            ],
        },
    }
