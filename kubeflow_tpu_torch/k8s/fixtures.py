"""Fake kubelet and GPU node-pool fixtures for the cluster tests.

The port's own copy of ``kubeflow_tpu/k8s/fixtures.py`` on GPU nodes. A
``FakeKubelet`` turns StatefulSets into indexed pods, binds them to fake
nodes honoring ``nvidia.com/gpu`` allocatable and the node label that
``gpu/topology.py``'s ``node_selector`` gives, and marks them Ready, so a
test can assert "Notebook → N Ready host pods", and a scheduling failure
(wrong node type, exhausted pool) shows as a Pending pod, as on a real
cluster. ``add_gpu_node_pool`` takes the place of JAX's
``add_tpu_node_pool``; ``FakePodRunner`` is JAX's.
"""

from __future__ import annotations

import copy
from typing import Optional

from kubeflow_tpu_torch.k8s import objects as obj_util
from kubeflow_tpu_torch.k8s.errors import AlreadyExistsError, NotFoundError
from kubeflow_tpu_torch.k8s.fake import FakeCluster
from kubeflow_tpu_torch.k8s.manager import Manager, Reconciler, Request, Result

POD_INDEX_LABEL = "apps.kubernetes.io/pod-index"
STS_POD_NAME_LABEL = "statefulset.kubernetes.io/pod-name"
GPU_RESOURCE = "nvidia.com/gpu"
# The node label gpu/topology.py's node_selector() schedules on.
GPU_NODE_LABEL = "cloud.google.com/gke-accelerator"


def add_gpu_node_pool(
    cluster: FakeCluster,
    accelerator_label: str,
    topology: str,
    hosts: int,
    cards_per_host: int,
    name_prefix: str = "gpu-node",
) -> list[str]:
    """Create ``hosts`` fake Nodes of one GPU node type: each carries the
    ``cloud.google.com/gke-accelerator`` label and ``cards_per_host``
    ``nvidia.com/gpu`` allocatable."""
    names = []
    for i in range(hosts):
        name = f"{name_prefix}-{topology}-{i}"
        node = {
            "apiVersion": "v1",
            "kind": "Node",
            "metadata": {
                "name": name,
                "labels": {
                    GPU_NODE_LABEL: accelerator_label,
                },
            },
            "status": {
                "allocatable": {GPU_RESOURCE: str(cards_per_host)},
                "conditions": [{"type": "Ready", "status": "True"}],
            },
        }
        try:
            cluster.create(node)
        except AlreadyExistsError:
            pass
        names.append(name)
    return names


def add_cpu_node(cluster: FakeCluster, name: str = "cpu-node-0") -> str:
    try:
        cluster.create(
            {
                "apiVersion": "v1",
                "kind": "Node",
                "metadata": {"name": name, "labels": {}},
                "status": {
                    "allocatable": {},
                    "conditions": [{"type": "Ready", "status": "True"}],
                },
            }
        )
    except AlreadyExistsError:
        pass
    return name


class FakeKubelet(Reconciler):
    """Reconciles StatefulSets into scheduled, Ready, indexed pods."""

    def __init__(self, cluster: FakeCluster, auto_ready: bool = True):
        self.cluster = cluster
        self.auto_ready = auto_ready

    def register(self, manager: Manager) -> None:
        def all_sts(ev):
            return [
                Request(obj_util.name_of(s), obj_util.namespace_of(s))
                for s in self.cluster.list("StatefulSet")
            ]

        def pod_capacity_freed_to_all_sts(ev):
            # Capacity-freed signal: a deleted pod — or one that turned
            # Succeeded (terminal pods release their node's GPU
            # allocatable, see _schedule) — lets OTHER StatefulSets'
            # Unschedulable-Pending pods bind (the real scheduler's
            # retry-on-capacity). Failed pods converge via the owner's
            # own reconcile (it deletes them → a DELETED event lands
            # here). Scoped to these rare transitions so the per-pod
            # create/status chatter of a spawning slice cannot amplify
            # into O(n²) reconciles.
            freed = ev.type == "DELETED" or (
                ev.type == "MODIFIED"
                and ev.object.get("status", {}).get("phase") == "Succeeded"
            )
            return all_sts(ev) if freed else []

        manager.register(
            self,
            for_kind="StatefulSet",
            owns=("Pod",),
            watches=[("Node", all_sts),
                     ("Pod", pod_capacity_freed_to_all_sts)],
            name="FakeKubelet",
        )

    def reconcile(self, req: Request) -> Result:
        try:
            sts = self.cluster.get("StatefulSet", req.name, req.namespace)
        except NotFoundError:
            return Result()
        replicas = sts.get("spec", {}).get("replicas", 1)
        # ONE namespace pod list per reconcile serves the hot-path
        # consumers below (ordinal exists-checks, the scale-down scan,
        # the ready count): relisting per POD would make each reconcile
        # O(cluster · replicas) round-trips. Pods this reconcile creates/updates are
        # folded into the cache by hand, so the view stays coherent
        # without re-listing.
        ns_pods = {
            obj_util.name_of(p): p
            for p in self.cluster.list("Pod", req.namespace)
        }
        # Scheduling state (cluster-wide usage + node list — binding must
        # respect pods in OTHER namespaces too) is LAZY: a steady-state
        # reconcile (all pods exist and bound) pays for neither list.
        # scheduler() always runs before this reconcile creates any pod,
        # so its snapshot is coherent; bindings update `used` in place.
        sched_state: list = []

        def scheduler():
            if not sched_state:
                used: dict[str, int] = {}
                for existing in self.cluster.list("Pod"):
                    node_name = existing.get("spec", {}).get("nodeName")
                    phase = existing.get("status", {}).get("phase")
                    if node_name and phase not in ("Failed", "Succeeded"):
                        used[node_name] = (
                            used.get(node_name, 0) + _pod_gpu_request(existing)
                        )
                sched_state.append((self.cluster.list("Node"), used))
            return sched_state[0]

        for i in range(replicas):
            self._ensure_pod(sts, i, ns_pods, scheduler)
            self._retry_pending(sts, i, ns_pods, scheduler)
        for pod in list(ns_pods.values()):
            if not obj_util.is_controlled_by(sts, pod):
                continue
            idx = pod["metadata"].get("labels", {}).get(POD_INDEX_LABEL)
            # Scale-down: remove pods at ordinals >= replicas (whole-slice stop).
            scale_down = idx is not None and int(idx) >= replicas
            # The real StatefulSet controller deletes Failed pods so they are
            # recreated — preemption recovery converges even without a
            # slice-health controller.
            failed = pod.get("status", {}).get("phase") == "Failed"
            if scale_down or failed:
                try:
                    self.cluster.delete("Pod", obj_util.name_of(pod), req.namespace)
                except NotFoundError:
                    pass
                del ns_pods[obj_util.name_of(pod)]
        self._update_sts_status(sts, ns_pods)
        return Result()

    # -- pod lifecycle -----------------------------------------------------

    def _ensure_pod(self, sts: dict, ordinal: int, ns_pods: dict,
                    scheduler) -> None:
        name = f"{obj_util.name_of(sts)}-{ordinal}"
        namespace = obj_util.namespace_of(sts)
        if name in ns_pods:
            return
        template = copy.deepcopy(sts.get("spec", {}).get("template", {}))
        pod = {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": name,
                "namespace": namespace,
                "labels": {
                    **template.get("metadata", {}).get("labels", {}),
                    POD_INDEX_LABEL: str(ordinal),
                    STS_POD_NAME_LABEL: name,
                },
                "annotations": dict(template.get("metadata", {}).get("annotations", {})),
            },
            "spec": copy.deepcopy(template.get("spec", {})),
        }
        pod["spec"]["hostname"] = name
        if sts.get("spec", {}).get("serviceName"):
            pod["spec"]["subdomain"] = sts["spec"]["serviceName"]
        obj_util.set_controller_reference(sts, pod)
        node = self._schedule(pod, scheduler)
        if node:
            pod["spec"]["nodeName"] = node
            pod["status"] = self._running_status(pod) if self.auto_ready else {
                "phase": "Pending",
                "conditions": [{"type": "PodScheduled", "status": "True"}],
            }
        else:
            pod["status"] = {
                "phase": "Pending",
                "conditions": [
                    {
                        "type": "PodScheduled",
                        "status": "False",
                        "reason": "Unschedulable",
                        "message": "0/N nodes match GPU nodeSelector/allocatable",
                    }
                ],
            }
        ns_pods[name] = self.cluster.create(pod) or pod

    def _retry_pending(self, sts: dict, ordinal: int, ns_pods: dict,
                       scheduler) -> None:
        """Reschedule an unschedulable Pending pod once capacity appears."""
        name = f"{obj_util.name_of(sts)}-{ordinal}"
        pod = ns_pods.get(name)
        if pod is None:
            return
        status = pod.get("status", {})
        if status.get("phase") != "Pending" or pod["spec"].get("nodeName"):
            return
        node = self._schedule(pod, scheduler)
        if not node:
            return
        pod["spec"]["nodeName"] = node
        pod = self.cluster.update(pod)
        pod["status"] = self._running_status(pod) if self.auto_ready else {
            "phase": "Pending",
            "conditions": [{"type": "PodScheduled", "status": "True"}],
        }
        ns_pods[name] = self.cluster.update_status(pod) or pod

    def _schedule(self, pod: dict, scheduler) -> Optional[str]:
        """Bind to a node satisfying nodeSelector + nvidia.com/gpu allocatable.

        Terminal pods (Failed/Succeeded) release their resources, as on a
        real cluster — preemption recovery depends on this. ``scheduler``
        lazily supplies (nodes, per-node usage) computed ONCE per
        reconcile; bindings made here update the usage map in place so
        sibling ordinals in the same reconcile see them.
        """
        selector = pod["spec"].get("nodeSelector", {})
        gpu_request = _pod_gpu_request(pod)
        nodes, used = scheduler()
        for node in nodes:
            labels = node.get("metadata", {}).get("labels", {})
            if any(labels.get(k) != v for k, v in selector.items()):
                continue
            allocatable = int(
                node.get("status", {}).get("allocatable", {}).get(GPU_RESOURCE, 0)
            )
            node_name = obj_util.name_of(node)
            if gpu_request and used.get(node_name, 0) + gpu_request > allocatable:
                continue
            used[node_name] = used.get(node_name, 0) + gpu_request
            return node_name
        return None

    def _running_status(self, pod: dict) -> dict:
        return {
            "phase": "Running",
            "conditions": [
                {"type": "PodScheduled", "status": "True"},
                {"type": "Initialized", "status": "True"},
                {"type": "ContainersReady", "status": "True"},
                {"type": "Ready", "status": "True"},
            ],
            "containerStatuses": [
                {
                    "name": c.get("name", ""),
                    "ready": True,
                    "restartCount": 0,
                    "state": {"running": {"startedAt": "2026-01-01T00:00:00Z"}},
                }
                for c in pod["spec"].get("containers", [])
            ],
        }

    def _update_sts_status(self, sts: dict, ns_pods: "dict | None" = None) -> None:
        from kubeflow_tpu_torch.k8s.client import retry_on_conflict

        name, ns = obj_util.name_of(sts), obj_util.namespace_of(sts)
        attempts = [0]

        def write():
            # Whole read-compute-write inside the retry: another writer
            # may update the same StatefulSet concurrently, and a stale rv
            # must retry as a real kubelet does. The FIRST attempt counts ready pods from this
            # reconcile's own cache (pod Ready status has no writer but
            # this kubelet); a CONFLICT is the signal another writer is
            # active, so every retry re-lists and recomputes fresh.
            fresh = self.cluster.get("StatefulSet", name, ns)
            if attempts[0] == 0 and ns_pods is not None:
                pods = list(ns_pods.values())
            else:
                pods = self.cluster.list("Pod", ns)
            attempts[0] += 1
            ready = 0
            for pod in pods:
                if not obj_util.is_controlled_by(fresh, pod):
                    continue
                for cond in pod.get("status", {}).get("conditions", []):
                    if (cond.get("type") == "Ready"
                            and cond.get("status") == "True"):
                        ready += 1
            fresh["status"] = {
                "replicas": fresh.get("spec", {}).get("replicas", 1),
                "readyReplicas": ready,
            }
            self.cluster.update_status(fresh)

        retry_on_conflict(write)

    # -- fault helpers for preemption tests --------------------------------

    def preempt_pod(self, name: str, namespace: str, reason: str = "TerminationByKubernetes") -> None:
        """Simulate a maintenance/spot preemption: the pod dies with a reason."""
        pod = self.cluster.get("Pod", name, namespace)
        pod["status"] = {
            "phase": "Failed",
            "reason": "Preempted",
            "message": f"Pod preempted: {reason}",
            "conditions": [
                {
                    "type": "DisruptionTarget",
                    "status": "True",
                    "reason": reason,
                }
            ],
        }
        self.cluster.update_status(pod)


def _pod_gpu_request(pod: dict) -> int:
    total = 0
    for c in pod.get("spec", {}).get("containers", []):
        total += int(c.get("resources", {}).get("limits", {}).get(GPU_RESOURCE, 0) or 0)
    return total


class FakePodRunner(Reconciler):
    """Runs node-pinned, ownerless, run-to-completion pods — the fake
    analog of a kubelet executing a DaemonSet-style pinned pod (e.g. the
    image pre-puller's): any Pod with ``spec.nodeName`` already set, no
    ownerReferences, and ``restartPolicy: Never`` is driven to
    ``Succeeded`` (image pulls complete instantly in the fake).

    ``fail_images`` lets chaos tests model broken registries: a pod
    whose spec references one of those images lands ``Failed`` instead
    (the pre-puller's retry loop is delete + re-create)."""

    def __init__(self, cluster: FakeCluster, fail_images: frozenset = frozenset()):
        self.cluster = cluster
        self.fail_images = frozenset(fail_images)

    def register(self, manager: Manager) -> None:
        manager.register(self, for_kind="Pod", name="FakePodRunner")

    def reconcile(self, req: Request) -> Result:
        try:
            pod = self.cluster.get("Pod", req.name, req.namespace)
        except NotFoundError:
            return Result()
        spec = pod.get("spec", {})
        meta = pod.get("metadata", {})
        if (
            not spec.get("nodeName")
            or meta.get("ownerReferences")
            or spec.get("restartPolicy") != "Never"
        ):
            return Result()
        if pod.get("status", {}).get("phase") in ("Succeeded", "Failed"):
            return Result()
        images = {
            c.get("image")
            for c in spec.get("containers", []) + spec.get("initContainers", [])
        }
        failed = images & self.fail_images
        pod["status"] = {
            "phase": "Failed" if failed else "Succeeded",
            **(
                {
                    "message": f"image pull failed: {sorted(failed)[0]}",
                    # Failure-time stamp, as a real kubelet records it —
                    # retry backoffs key off THIS, not creationTimestamp.
                    "containerStatuses": [{
                        "name": "done",
                        "state": {"terminated": {
                            "exitCode": 1,
                            "finishedAt": self.cluster._now(),
                        }},
                    }],
                }
                if failed else {}
            ),
        }
        self.cluster.update_status(pod)
        return Result()
