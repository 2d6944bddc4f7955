"""The runtime env of a GPU notebook, and the admission projections.

The counterpart of ``kubeflow_tpu/webhook/tpu_env.py``'s
``inject_tpu_env`` and of the pure steps of
``kubeflow_tpu/webhook/mutating.py``. It writes the env that
``runtime.bootstrap`` reads in the pod, under the JAX package's names:

- ``TPU_WORKER_ID``: this host's index, from the indexed StatefulSet's
  pod-index label through the downward API;
- ``TPU_WORKER_HOSTNAMES``: every host's stable DNS name;
- ``TPU_ACCELERATOR_TYPE``, ``TPU_TOPOLOGY``: the slice's shape;
- ``TPU_CHIPS_PER_HOST_BOUNDS``, ``TPU_HOST_BOUNDS``: the cards of one
  host and the hosts, which ``bootstrap`` multiplies into one rank a card;
- ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``: worker 0's
  rendezvous and the host count, on several hosts only.

``TPU_RUNTIME_VERSION`` is never written (it names a libtpu); a stale one
is removed. ``mutating.NotebookMutatingWebhook`` runs these steps among
the rest of the admission pipeline (image resolution, the mounts, the
auth sidecar, MLflow, the cluster proxy and update blocking), and
``server.py`` serves it over AdmissionReview. ``mutate_gpu_notebook``
is the device steps alone, for a caller with no validating webhook
behind it: it raises on a spec that does not resolve, where the
webhook skips it and leaves the denial to ``validating.py``.
"""

from __future__ import annotations

from kubeflow_tpu_torch.api import annotations as ann
from kubeflow_tpu_torch.api.names import JAX_COORDINATOR_PORT
from kubeflow_tpu_torch.api.notebook import Notebook
from kubeflow_tpu_torch.gpu.topology import SliceTopology
from kubeflow_tpu_torch.runtime import env as envc

POD_INDEX_LABEL = "apps.kubernetes.io/pod-index"
_POD_INDEX_FIELD = f"metadata.labels['{POD_INDEX_LABEL}']"

# Headroom added to the emergency-save budget when sizing
# terminationGracePeriodSeconds: container teardown, the volume's flush
# and the process's own shutdown eat into the kubelet's window.
CHECKPOINT_FLUSH_MARGIN_S = 30
# The Kubernetes default, when no grace annotation is present.
DEFAULT_TERMINATION_GRACE_S = 30


def termination_grace_seconds(grace: "int | None") -> int:
    """terminationGracePeriodSeconds for a pod whose emergency checkpoint
    budget is ``grace`` seconds (None: the Kubernetes default)."""
    if grace is None:
        return DEFAULT_TERMINATION_GRACE_S
    return int(grace) + CHECKPOINT_FLUSH_MARGIN_S


def inject_gpu_env(
    nb: Notebook, topo: SliceTopology, cluster_domain: str = "cluster.local"
) -> bool:
    """Idempotently set the slice env on the primary container.

    Returns True if the pod template changed. Values are recomputed from
    the current spec, so topology edits (on stopped notebooks) roll
    forward."""
    container = nb.primary_container()
    if container is None:
        return False
    # Name derivation must match the controller exactly, the long-name
    # hashed fallback included.
    from kubeflow_tpu_torch.controller.notebook import (
        headless_service_name,
        slice_sts_name,
    )

    headless = headless_service_name(nb.name)
    hostnames = topo.worker_hostnames(
        slice_sts_name(nb.name, 0), headless, nb.namespace, cluster_domain
    )
    desired: list[dict] = [
        {
            "name": envc.TPU_WORKER_ID,
            "valueFrom": {"fieldRef": {"fieldPath": _POD_INDEX_FIELD}},
        },
        {"name": envc.TPU_WORKER_HOSTNAMES, "value": ",".join(hostnames)},
        {"name": envc.TPU_ACCELERATOR_TYPE, "value": topo.accelerator_type},
        {"name": envc.TPU_TOPOLOGY, "value": topo.topology_str},
        {"name": envc.TPU_CHIPS_PER_HOST_BOUNDS,
         "value": topo.chip_bounds_str()},
        {"name": envc.TPU_HOST_BOUNDS, "value": topo.host_bounds_str()},
    ]
    stale = {envc.TPU_RUNTIME_VERSION}
    if topo.hosts > 1:
        desired += [
            {
                "name": envc.JAX_COORDINATOR_ADDRESS,
                "value": f"{hostnames[0]}:{JAX_COORDINATOR_PORT}",
            },
            {"name": envc.JAX_NUM_PROCESSES, "value": str(topo.hosts)},
        ]
    else:
        # A topology edit that shrank the slice to one host drops the
        # multi-host env, or bootstrap would wait for workers that no
        # longer exist.
        stale |= {envc.JAX_COORDINATOR_ADDRESS, envc.JAX_NUM_PROCESSES}
    changed = upsert_env(container, desired)
    changed |= remove_env(container, stale)
    return changed


def upsert_env(container: dict, desired: list[dict]) -> bool:
    """Merge env entries by name; True if anything changed."""
    env = container.setdefault("env", [])
    changed = False
    by_name = {e.get("name"): i for i, e in enumerate(env)}
    for entry in desired:
        idx = by_name.get(entry["name"])
        if idx is None:
            env.append(entry)
            by_name[entry["name"]] = len(env) - 1
            changed = True
        elif env[idx] != entry:
            env[idx] = entry
            changed = True
    return changed


def remove_env(container: dict, names: set[str]) -> bool:
    env = container.get("env", [])
    kept = [e for e in env if e.get("name") not in names]
    if len(kept) != len(env):
        container["env"] = kept
        return True
    return False


def mutate_gpu_notebook(obj: dict, cluster_domain: str = "cluster.local"
                        ) -> dict:
    """The admission steps that depend on the device, in the JAX
    webhook's order: the slice env and the resolved-topology annotation,
    then the quantization, profiling-port, serving-port and checkpoint
    projections. Mutates ``obj`` in place and returns it. A spec that
    does not resolve raises InvalidTopologyError: there is no validating
    webhook behind this one to deny it."""
    nb = Notebook(obj)
    gpu = nb.gpu
    if gpu is not None:
        topo = gpu.slice_topology()
        inject_gpu_env(nb, topo, cluster_domain)
        nb.annotations[ann.TPU_RESOLVED_TOPOLOGY] = (
            f"{topo.accelerator_type}/{topo.topology_str}")
    project_quant_env(nb)
    project_port_env(nb, ann.TPU_PROFILING_PORT, ann.PROFILING_ENV_NAME)
    project_port_env(nb, ann.TPU_SERVING_PORT, ann.SERVING_ENV_NAME)
    if gpu is not None:
        project_checkpoint_env(nb)
    return obj


def project_quant_env(nb: Notebook) -> None:
    """The quantization annotation into the serving env; "bf16", absence
    and unknown values all leave it unset."""
    container = nb.primary_container()
    if container is None:
        return
    value = nb.annotations.get(ann.TPU_QUANTIZATION, "")
    if value in ("", "bf16") or value not in ann.TPU_QUANTIZATION_VALUES:
        remove_env(container, {ann.QUANT_ENV_NAME})
        return
    upsert_env(container, [{"name": ann.QUANT_ENV_NAME, "value": value}])


def project_port_env(nb: Notebook, annotation: str, env_name: str) -> None:
    """A port annotation into its env; an invalid one leaves it unset."""
    container = nb.primary_container()
    if container is None:
        return
    port = ann.parse_profiling_port(nb.annotations.get(annotation))
    if port is None:
        remove_env(container, {env_name})
        return
    upsert_env(container, [{"name": env_name, "value": str(port)}])


def project_checkpoint_env(nb: Notebook) -> None:
    """The checkpoint directory (the annotation, else the default) always;
    the grace budget, when valid, into the env and into
    terminationGracePeriodSeconds (budget plus the flush margin)."""
    container = nb.primary_container()
    if container is None:
        return
    ckpt_dir = (
        nb.annotations.get(ann.TPU_CHECKPOINT_DIR, "").strip()
        or ann.DEFAULT_CHECKPOINT_DIR
    )
    upsert_env(container,
               [{"name": ann.CHECKPOINT_DIR_ENV_NAME, "value": ckpt_dir}])
    grace = ann.parse_checkpoint_grace(
        nb.annotations.get(ann.TPU_CHECKPOINT_GRACE))
    if grace is None:
        remove_env(container, {ann.CHECKPOINT_GRACE_ENV_NAME})
        return
    upsert_env(container,
               [{"name": ann.CHECKPOINT_GRACE_ENV_NAME, "value": str(grace)}])
    nb.pod_spec["terminationGracePeriodSeconds"] = (
        termination_grace_seconds(grace))


def pod_env(container: dict, pod_index: int) -> dict[str, str]:
    """The env a container of the indexed StatefulSet's pod
    ``pod_index`` sees: each ``value`` as written, and the pod-index
    label's downward-API projection filled in. Any other ``valueFrom``
    raises ValueError: nothing here can resolve it."""
    out = {}
    for entry in container.get("env", []):
        name = entry["name"]
        if "valueFrom" in entry:
            if entry["valueFrom"] != {"fieldRef": {
                    "fieldPath": _POD_INDEX_FIELD}}:
                raise ValueError(
                    f"env {name}: cannot resolve valueFrom "
                    f"{entry['valueFrom']!r} outside a cluster")
            out[name] = str(pod_index)
        else:
            out[name] = entry.get("value", "")
    return out
