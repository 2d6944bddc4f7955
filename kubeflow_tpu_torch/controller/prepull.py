"""Image pre-pull reconciler: keep notebook images pulled on GPU nodes.

The port's own copy of ``kubeflow_tpu/controller/prepull.py`` over GPU
nodes. The reference's spawn path pulls images cold, and SlicePool keeps
images warm only on nodes its placeholders hold, so a multi-GB workbench
image on a COLD node costs the spawn its pull. This reconciler maintains
one node-pinned pre-pull Pod per GPU node (a node carrying the
``cloud.google.com/gke-accelerator`` label): the DaemonSet controller's
exact mechanics (DaemonSet pods bind via ``spec.nodeName``, not the
scheduler) without requiring DaemonSet semantics of the control plane:

- the image SET is the operator-listed refs in the
  ``notebook-prepull-images`` ConfigMap (controller namespace,
  key → image ref) UNION the images of live GPU notebooks, so a newly
  adopted workbench image starts warming on every GPU node at its first
  use, not at the next operator action;
- each pre-pull Pod pulls every image via initContainers that run a
  no-op and completes; it requests NO cards, tolerates everything, and
  carries the SlicePool placeholder PriorityClass so it can never
  displace, or even delay, a real workload;
- the pod NAME carries a content hash of the image set: set changes
  roll new pods, stale ones are deleted, Failed ones are deleted and
  re-created next reconcile (pull retry), and pods whose node is gone
  are GC'd. A Succeeded pod is its node's coverage marker for that set
  (node-local image GC can invalidate the marker silently: the same
  tradeoff every DaemonSet pre-puller makes).

Enabled by ``ENABLE_IMAGE_PREPULL=true`` on the core manager (gate
style: reference main.go:111-123 ``ENABLE_CULLING``).
"""

from __future__ import annotations

import hashlib
import logging
from dataclasses import dataclass
from typing import Optional

from kubeflow_tpu_torch.api import annotations as ann
from kubeflow_tpu_torch.api.names import derived_name
from kubeflow_tpu_torch.k8s import objects as obj_util
from kubeflow_tpu_torch.k8s.client import Client
from kubeflow_tpu_torch.k8s.errors import AlreadyExistsError, NotFoundError
from kubeflow_tpu_torch.k8s.manager import Manager, Reconciler, Request, Result
from kubeflow_tpu_torch.controller.slicepool import PLACEHOLDER_PRIORITY_CLASS

log = logging.getLogger(__name__)

PREPULL_CONFIGMAP = "notebook-prepull-images"
PREPULL_LABEL = ann.PREPULL_LABEL
# The label add_gpu_node_pool and gpu/topology.py's node_selector use.
GPU_NODE_LABEL = "cloud.google.com/gke-accelerator"
# A Failed pre-pull pod (broken ref, registry outage) is retried by
# delete + re-create, but only after this backoff — immediate recreation
# would hammer a broken registry once per watch event.
RETRY_FAILED_AFTER = 60.0

# The shared distroless-safe pull recipe: a pull container must exit 0
# no matter what the target image contains (distroless/scratch ship NO
# binaries), so a static busybox is copied into an emptyDir first and
# every target image runs THAT.
BUSYBOX_IMAGE = "busybox:1.36"
TOOLS_MOUNT = {"name": "prepull-tools", "mountPath": "/prepull-tools"}
TINY_RESOURCES = {"limits": {"cpu": "100m", "memory": "64Mi"}}


def prepull_init_containers(images, name_prefix: str = "pull") -> list[dict]:
    """copy-busybox + one no-op-run per target image (serial pulls)."""
    return [
        {
            "name": "copy-busybox",
            "image": BUSYBOX_IMAGE,
            # Multicall binary: keep its own name, dispatch via argv —
            # renamed to "noop" it would exit 127 (applet not found).
            "command": ["cp", "/bin/busybox", "/prepull-tools/busybox"],
            "volumeMounts": [dict(TOOLS_MOUNT)],
            "resources": dict(TINY_RESOURCES),
        }
    ] + [
        {
            "name": f"{name_prefix}-{i}",
            "image": img,
            "command": ["/prepull-tools/busybox", "sleep", "0"],
            "volumeMounts": [dict(TOOLS_MOUNT)],
            "resources": dict(TINY_RESOURCES),
        }
        for i, img in enumerate(images)
    ]


def _failure_time(pod: dict) -> Optional[float]:
    """When the pod actually FAILED: the latest terminated finishedAt
    across container statuses, falling back to creationTimestamp. The
    backoff must key off failure, not creation — a pod failing after
    living past the window would otherwise retry with zero backoff."""
    latest = None
    status = pod.get("status") or {}
    for cs in (status.get("containerStatuses") or []) + (
        status.get("initContainerStatuses") or []
    ):
        fin = ((cs.get("state") or {}).get("terminated") or {}).get(
            "finishedAt"
        )
        t = obj_util.parse_timestamp(fin)
        if t is not None and (latest is None or t > latest):
            latest = t
    if latest is not None:
        return latest
    return obj_util.parse_timestamp(
        (pod.get("metadata") or {}).get("creationTimestamp")
    )


@dataclass
class PrePullConfig:
    namespace: str = "kubeflow"
    configmap: str = PREPULL_CONFIGMAP

    @classmethod
    def from_env(cls, env: dict) -> "PrePullConfig":
        return cls(
            namespace=env.get("K8S_NAMESPACE", "kubeflow"),
            configmap=env.get("IMAGE_PREPULL_CONFIGMAP", PREPULL_CONFIGMAP),
        )


def image_set(client: Client, cfg: PrePullConfig) -> list[str]:
    """Sorted union of operator-listed and live-GPU-notebook images."""
    images: set[str] = set()
    try:
        cm = client.get("ConfigMap", cfg.configmap, cfg.namespace)
        images.update(v for v in (cm.get("data") or {}).values() if v)
    except NotFoundError:
        pass
    for nb in client.list("Notebook"):
        if not nb.get("spec", {}).get("gpu"):
            continue
        pod_spec = (
            nb.get("spec", {}).get("template", {}).get("spec", {})
        )
        for c in pod_spec.get("containers", []):
            if c.get("image"):
                images.add(c["image"])
    return sorted(images)


def image_set_digest(images: list[str]) -> str:
    return hashlib.sha1("\n".join(images).encode()).hexdigest()[:10]


def prepull_pod_name(node: str, digest: str) -> str:
    return derived_name(f"prepull-{node}", f"-{digest}")


def generate_prepull_pod(
    cfg: PrePullConfig, node: str, images: list[str], digest: str
) -> dict:
    """Node-pinned run-to-completion pod pulling every image.

    All images ride initContainers (serial pulls — kubelets pull one
    image at a time per pod anyway). A pull container must exit 0 no
    matter what the target image contains — distroless/scratch
    workbench images ship NO binaries — so busybox's static multicall
    binary is copied into an emptyDir first, then run from every target
    image's filesystem (prepull_init_containers). Tiny cpu/memory limits
    bound the (no-op) containers; no ``nvidia.com/gpu`` request, so the
    pod never takes a card the scheduler could give a notebook."""
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": prepull_pod_name(node, digest),
            "namespace": cfg.namespace,
            "labels": {PREPULL_LABEL: "true"},
            "annotations": {PREPULL_LABEL + "-node": node},
        },
        "spec": {
            "nodeName": node,
            "restartPolicy": "Never",
            "priorityClassName": PLACEHOLDER_PRIORITY_CLASS,
            "tolerations": [{"operator": "Exists"}],
            "volumes": [{"name": "prepull-tools", "emptyDir": {}}],
            "initContainers": prepull_init_containers(images),
            "containers": [
                {
                    "name": "done",
                    "image": BUSYBOX_IMAGE,
                    "command": ["/bin/busybox", "true"],
                    "resources": dict(TINY_RESOURCES),
                }
            ],
        },
    }


class PrePullReconciler(Reconciler):
    """Singleton reconcile: the whole desired state (image set × GPU
    nodes) is recomputed per wake-up — level-triggered, like every
    controller here. Anchored on the ConfigMap kind; node, notebook, and
    own-pod events map onto the one request."""

    def __init__(self, client: Client, config: Optional[PrePullConfig] = None,
                 metrics=None, clock=None, enabled: bool = True):
        self.client = client
        self.cfg = config or PrePullConfig()
        self.metrics = metrics
        self.clock = clock  # None → Failed pods retry without backoff
        # Disabled mode still registers and reconciles with an EMPTY
        # desired set: flipping ENABLE_IMAGE_PREPULL off must GC the
        # node-pinned pods a previous run created (they carry no
        # ownerReferences — nothing else would ever clean them up).
        self.enabled = enabled

    def register(self, manager: Manager) -> None:
        def singleton(ev) -> list[Request]:
            return [Request(self.cfg.configmap, self.cfg.namespace)]

        def own_pods(ev) -> list[Request]:
            labels = (ev.object.get("metadata") or {}).get("labels") or {}
            return singleton(ev) if PREPULL_LABEL in labels else []

        manager.register(
            self,
            for_kind="ConfigMap",
            watches=[
                ("Node", singleton),
                ("Notebook", singleton),
                ("Pod", own_pods),
            ],
            name="PrePullReconciler",
        )

    def reconcile(self, req: Request) -> Result:
        if req.name != self.cfg.configmap or req.namespace != self.cfg.namespace:
            return Result()  # some other ConfigMap's event
        images = image_set(self.client, self.cfg) if self.enabled else []
        digest = image_set_digest(images)
        nodes = [
            obj_util.name_of(n)
            for n in self.client.list("Node")
            if GPU_NODE_LABEL in ((n.get("metadata") or {}).get("labels") or {})
        ]
        desired = (
            {prepull_pod_name(node, digest): node for node in nodes}
            if images else {}
        )
        covered = 0
        existing = set()
        requeue = 0.0
        for pod in self.client.list("Pod", self.cfg.namespace):
            labels = (pod.get("metadata") or {}).get("labels") or {}
            if PREPULL_LABEL not in labels:
                continue
            name = obj_util.name_of(pod)
            phase = (pod.get("status") or {}).get("phase")
            stale = name not in desired  # old image set or vanished node
            retry = False
            if phase == "Failed" and not stale:
                failed_at = _failure_time(pod)
                age = (
                    self.clock.now() - failed_at
                    if self.clock is not None and failed_at is not None
                    else RETRY_FAILED_AFTER
                )
                if age >= RETRY_FAILED_AFTER:
                    retry = True
                else:
                    # Keep the Failed pod as the backoff marker; come
                    # back when its retry window opens.
                    wait = RETRY_FAILED_AFTER - age
                    requeue = min(requeue, wait) if requeue else wait
                    existing.add(name)
                    continue
            if stale or retry:
                try:
                    self.client.delete("Pod", name, self.cfg.namespace)
                except NotFoundError:
                    pass
                continue
            existing.add(name)
            if phase == "Succeeded":
                covered += 1
        for name, node in desired.items():
            if name in existing:
                continue
            try:
                self.client.create(
                    generate_prepull_pod(self.cfg, node, images, digest)
                )
            except AlreadyExistsError:
                pass  # raced our own cache; the watch will re-trigger
        if self.metrics is not None:
            self.metrics.prepull_nodes_covered.set(covered)
            self.metrics.prepull_nodes_target.set(len(desired))
        return Result(requeue_after=requeue)
