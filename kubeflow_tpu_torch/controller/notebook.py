"""The Notebook reconciler: a Notebook on GPU nodes as an indexed
StatefulSet and two Services, kept so by a level-triggered loop.

The port's own copy of ``kubeflow_tpu/controller/notebook.py``. A notebook
is N pods, one a host:

- no ``spec.gpu``: a 1-replica StatefulSet behind the routing Service;
- ``spec.gpu``: an indexed StatefulSet with ``replicas`` = the slice's
  hosts, ``podManagementPolicy: Parallel`` (a partial slice is useless,
  and its process group would wait), ``nvidia.com/gpu`` limits and
  requests of the host's cards on the primary container, the node type's
  nodeSelector (and ``cloud.google.com/gke-spot`` for spot), an
  ``nvidia.com/gpu`` toleration, and a headless Service that gives every
  host a stable DNS name;
- the stop annotation scales the whole slice to 0 at once; the restart
  annotation deletes every host's pod;
- a multislice notebook has one StatefulSet a slice, whose pods carry
  their slice-local index, with the ``MEGASCALE_*`` and ``JAX_*`` env that
  spans every slice.

``NotebookReconciler`` runs the generators under a ``k8s.Manager``:
it claims a warm SlicePool slice on every 0→N scale-up, prunes slices
past ``sliceCount``, mirrors pod state into the Notebook's status,
re-emits the pods' Warning events onto the Notebook (deduplicated by a
cursor annotation), and, under ``USE_ISTIO``, renders a VirtualService.

Everything is the JAX package's but these stated replacements:
``nvidia.com/gpu`` for ``google.com/tpu``, the GPU node label for the
TPU ones, ``status.gpu`` for ``status.tpu`` (with the same fields), the
condition ``GPUTopologyValid`` for ``TPUTopologyValid`` and the event
reason ``InvalidGPUTopology`` for ``InvalidTPUTopology``.
"""

from __future__ import annotations

import copy
import json
import logging
import time
from dataclasses import dataclass
from typing import Callable, Optional

from kubeflow_tpu_torch.api import annotations as ann
from kubeflow_tpu_torch.api.names import (
    JAX_COORDINATOR_PORT,
    MEGASCALE_PORT,
    NOTEBOOK_PORT,
    derived_name,
    routing_service_name,
)
from kubeflow_tpu_torch.api.notebook import MAX_NAME_LENGTH, Notebook
from kubeflow_tpu_torch.api.slicepool import CLAIMED_FROM
from kubeflow_tpu_torch.controller import reconcilehelper as helper
from kubeflow_tpu_torch.controller.slicepool import claim_warm_slice
from kubeflow_tpu_torch.gpu.topology import InvalidTopologyError, SliceTopology
from kubeflow_tpu_torch.k8s import objects as obj_util
from kubeflow_tpu_torch.k8s.client import Client, retry_on_conflict
from kubeflow_tpu_torch.k8s.errors import NotFoundError
from kubeflow_tpu_torch.k8s.events import EventRecorder
from kubeflow_tpu_torch.k8s.manager import Manager, Reconciler, Request, Result
from kubeflow_tpu_torch.metrics import Metrics
from kubeflow_tpu_torch.observability import tracing
from kubeflow_tpu_torch.runtime import env as envc
from kubeflow_tpu_torch.webhook.gpu_env import POD_INDEX_LABEL, upsert_env

log = logging.getLogger(__name__)

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


# Dedup-cursor token regimes (compared as STRINGS; '!' < '.' < '0'..'9'):
# the priming floor sorts below everything, timestamp tokens below every
# integer token — so on an integer-rv cluster (etcd) one anomalous
# rv-less Event is merely dropped instead of poisoning the cursor into a
# regime that would suppress all future integer events.
_CURSOR_FLOOR = "!"
_TS_PREFIX = "."


def _event_token(event: dict) -> str:
    """Orderable dedup token for an Event, compared as STRINGS.

    Primary regime: integer resourceVersions (etcd's monotonic revisions —
    the pragmatic ordering informer resume relies on), zero-padded so
    lexicographic order equals numeric order. Fallback regime for
    apiservers whose rvs are genuinely opaque (the API contract allows
    it): the Event's RFC3339 lastTimestamp with the event NAME as a
    tiebreaker — timestamps have 1-second granularity, and two Warnings
    in the same second must not collide into one token (the collision
    would drop the second forever). Residual, documented limitation of
    the opaque regime: an event recorded AFTER the cursor advanced, with
    the same second and a lexically smaller name, is missed — bounded to
    one second of history, versus etcd's unique revisions which never
    collide."""
    meta = event.get("metadata", {})
    rv = meta.get("resourceVersion", "")
    try:
        return f"{int(rv):020d}"
    except (TypeError, ValueError):
        ts = (
            event.get("lastTimestamp")
            or meta.get("creationTimestamp")
            or ""
        )
        return f"{_TS_PREFIX}{ts}/{meta.get('name', '')}"


def _cursor_token(raw: str) -> str:
    """Normalize a stored cursor annotation into token form (upgrades
    cursors written by the older raw-int scheme)."""
    if not raw:
        return ""
    try:
        return f"{int(raw):020d}"
    except (TypeError, ValueError):
        return raw


def _token_regime(tok: str) -> str:
    """Which dedup regime a token belongs to: "int" (zero-padded etcd
    revision), "ts" (timestamp/name fallback), or "" (floor/empty —
    regime not yet pinned)."""
    if not tok or tok == _CURSOR_FLOOR:
        return ""
    return "ts" if tok.startswith(_TS_PREFIX) else "int"


@dataclass
class ControllerConfig:
    """Env-sourced knobs (reference manager.yaml:28-58 ConfigMap wiring)."""

    add_fsgroup: bool = True
    cluster_domain: str = "cluster.local"
    default_working_dir: str = "/home/jovyan"
    # Istio mode (reference notebook_controller.go:238, manager.yaml:28-43):
    # the kubeflow overlay serves notebooks through an Istio
    # VirtualService; standalone/GKE use Gateway-API HTTPRoutes.
    use_istio: bool = False
    istio_gateway: str = "kubeflow/kubeflow-gateway"
    istio_host: str = "*"

    @classmethod
    def from_env(cls, env: dict) -> "ControllerConfig":
        return cls(
            add_fsgroup=env.get("ADD_FSGROUP", "true").lower() != "false",
            cluster_domain=env.get("CLUSTER_DOMAIN", "cluster.local"),
            use_istio=env.get("USE_ISTIO", "").lower() == "true",
            istio_gateway=env.get("ISTIO_GATEWAY") or "kubeflow/kubeflow-gateway",
            istio_host=env.get("ISTIO_HOST") or "*",
        )


def headless_service_name(notebook_name: str) -> str:
    # Service names get the full 63-character DNS label budget.
    return derived_name(notebook_name, "-hosts", 63)


def virtual_service_name(notebook_name: str, namespace: str) -> str:
    """Reference virtualServiceName (notebook_controller.go:554-556)."""
    return f"notebook-{namespace}-{notebook_name}"


def generate_virtual_service(nb: Notebook, config: ControllerConfig) -> dict:
    """Istio VirtualService routing ``/notebook/{ns}/{name}/`` to the
    notebook Service (reference generateVirtualService,
    notebook_controller.go:558-658; apiVersion v1beta1).

    Annotation overrides, as the reference: ``http-rewrite-uri`` replaces
    the rewrite target; ``http-headers-request-set`` is a JSON object of
    request headers to set (malformed JSON degrades to no headers rather
    than failing the reconcile)."""
    prefix = f"/notebook/{nb.namespace}/{nb.name}/"
    rewrite = nb.annotations.get(ann.REWRITE_URI) or prefix
    headers = {}
    raw = nb.annotations.get(ann.HEADERS_REQUEST_SET)
    if raw:
        try:
            parsed = json.loads(raw)
            if isinstance(parsed, dict):
                headers = {str(k): str(v) for k, v in parsed.items()}
        except ValueError:
            headers = {}
    # The ROUTING SERVICE's name, not the raw notebook name: names over
    # the 63-char Service budget get the deterministic hashed fallback
    # (api.names.derived_name), and a mismatch here would 503 every
    # long-named notebook through Istio while all children look healthy.
    service = (
        f"{routing_service_name(nb.name)}.{nb.namespace}"
        f".svc.{config.cluster_domain}"
    )
    return {
        "apiVersion": "networking.istio.io/v1beta1",
        "kind": "VirtualService",
        "metadata": {
            "name": virtual_service_name(nb.name, nb.namespace),
            "namespace": nb.namespace,
        },
        "spec": {
            "hosts": [config.istio_host],
            "gateways": [config.istio_gateway],
            "http": [
                {
                    "headers": {"request": {"set": headers}},
                    "match": [{"uri": {"prefix": prefix}}],
                    "rewrite": {"uri": rewrite},
                    "route": [
                        {
                            "destination": {
                                "host": service,
                                "port": {"number": 80},
                            }
                        }
                    ],
                }
            ],
        },
    }


def slice_sts_name(notebook_name: str, slice_id: int) -> str:
    """StatefulSet name of one slice: slice 0 keeps the bare notebook
    name whenever it fits, later ones add ``-s{j}``; names over the
    52-character budget take the hashed fallback."""
    suffix = "" if slice_id == 0 else f"-s{slice_id}"
    return derived_name(notebook_name, suffix, MAX_NAME_LENGTH)


def slice_sts_names(notebook_name: str, slice_count: int) -> list[str]:
    return [slice_sts_name(notebook_name, j) for j in range(slice_count)]


class NotebookReconciler(Reconciler):
    def __init__(
        self,
        client: Client,
        config: Optional[ControllerConfig] = None,
        metrics: Optional[Metrics] = None,
        recorder: Optional[EventRecorder] = None,
        clock: Optional[Callable[[], float]] = None,
    ):
        self.client = client
        self.config = config or ControllerConfig()
        self.metrics = metrics or Metrics(client)
        self.recorder = recorder or EventRecorder(client)
        self.clock = clock or time.time
        # Notebooks whose slice-ready latency was already observed.
        self._ready_observed: set[tuple[str, str]] = set()

    def register(self, manager: Manager) -> None:
        manager.register(
            self,
            for_kind="Notebook",
            owns=("StatefulSet", "Service"),
            watches=[
                ("Pod", _pod_to_notebook),
                ("Event", _event_to_notebook),
            ],
            name="NotebookReconciler",
        )

    # ------------------------------------------------------------------
    def reconcile(self, req: Request) -> Result:
        # Root span per reconcile pass; the phase methods below hang
        # child spans off it (StatefulSet apply, Services/routes, status
        # mirroring) so a slow reconcile decomposes in the trace export.
        with tracing.get_tracer("controller").start_span(
            "reconcile", notebook=req.name, namespace=req.namespace,
        ):
            return self._reconcile(req)

    def _reconcile(self, req: Request) -> Result:
        try:
            obj = self.client.get("Notebook", req.name, req.namespace)
        except NotFoundError:
            return Result()
        if "deletionTimestamp" in obj["metadata"]:
            # Deletion cleanup is finalizer-driven (platform controller);
            # child objects go via ownerReference GC.
            return Result()
        nb = Notebook(obj)


        # Resolve the GPU slice up front; an invalid spec must never
        # produce a half-scheduled slice. ``nb.gpu`` itself refuses a
        # notebook with both blocks or a runtimeVersion.
        try:
            gpu = nb.gpu
            slice_topo = gpu.slice_topology() if gpu is not None else None
        except InvalidTopologyError as err:
            self.recorder.eventf(obj, "Warning", "InvalidGPUTopology", str(err))
            self._set_condition(
                nb, "GPUTopologyValid", "False", "InvalidTopology", str(err)
            )
            return Result()
        if slice_topo is not None:
            self._set_condition(
                nb, "GPUTopologyValid", "True", "Resolved",
                f"{slice_topo.accelerator_type} ({slice_topo.hosts} hosts)",
            )

        slice_count = gpu.slice_count if gpu is not None else 1
        with tracing.get_tracer("controller").start_span(
            "reconcile.statefulsets", slices=slice_count,
        ):
            self._reconcile_slices(obj, nb, slice_topo, slice_count)
        if nb.stopped:
            self._clear_claim_annotations(obj, nb)

        with tracing.get_tracer("controller").start_span(
            "reconcile.services",
        ):
            service = generate_service(nb)
            helper.reconcile_child(
                self.client, obj, service, helper.copy_service_fields
            )
            if slice_topo is not None:
                headless = generate_headless_service(nb, slice_topo)
                helper.reconcile_child(
                    self.client, obj, headless, helper.copy_service_fields
                )
            if self.config.use_istio:
                helper.reconcile_child(
                    self.client, obj,
                    generate_virtual_service(nb, self.config),
                    helper.copy_virtual_service_fields,
                )

        with tracing.get_tracer("controller").start_span(
            "reconcile.status",
        ):
            self._reemit_pod_events(nb, slice_topo)
            self._update_status(nb, slice_topo)
            self._handle_restart(nb, slice_topo)
        return Result()

    def _reconcile_slices(self, obj: dict, nb: Notebook,
                          slice_topo, slice_count: int) -> None:
        """The StatefulSet-apply phase of one reconcile pass (its own
        child span): per-slice generate/diff/apply plus warm-pool claims
        and stale-slice pruning."""
        created_any = False
        for slice_id in range(slice_count):
            sts = generate_statefulset(
                nb, slice_topo, self.config,
                slice_id=slice_id, slice_count=slice_count,
            )
            try:
                existing = self.client.get(
                    "StatefulSet", obj_util.name_of(sts), nb.namespace
                )
            except NotFoundError:
                existing = None
            # Claim a warm slice on every 0→N replica transition, not just
            # first creation: the webhook's reconciliation lock means the
            # STS is born at replicas 0 and scales up only after the
            # platform reconciler releases the lock (the production path),
            # and a culled notebook's RESUME re-acquires capacity too. The
            # ownership check mirrors _reconcile_statefulset's no-adopt
            # guard — a name-collision STS stuck at 0 replicas must not
            # drain the pool on every reconcile.
            scaling_up = slice_topo is not None and not nb.stopped and (
                existing is None
                or (
                    existing.get("spec", {}).get("replicas", 0) == 0
                    and obj_util.is_controlled_by(obj, existing)
                )
            )
            if scaling_up:
                self._maybe_claim_warm_slice(obj, nb, slice_topo, slice_id)
            created_any |= self._reconcile_statefulset(obj, sts, existing)
        if created_any:
            self.metrics.create_total.inc()
            # Long names fall back to deterministic hashed StatefulSet
            # names (reference GenerateName fallback,
            # notebook_controller.go:145-149) instead of a silently-never-
            # scheduled notebook; surface the substitution on creation so
            # the user can find their pods (not every reconcile — eventf
            # costs API round-trips).
            fallback_names = [
                n for j in range(slice_count)
                if (n := slice_sts_name(nb.name, j))
                != (nb.name if j == 0 else f"{nb.name}-s{j}")
            ]
            if fallback_names:
                self.recorder.eventf(
                    obj, "Normal", "LongNameFallback",
                    f"Notebook name exceeds {MAX_NAME_LENGTH} characters "
                    f"for its slice layout; using generated StatefulSet "
                    f"name(s) {', '.join(fallback_names)}",
                )
        self._prune_stale_slice_sts(nb, slice_count)

    # ------------------------------------------------------------------
    @staticmethod
    def _claim_marker_key(slice_id: int) -> str:
        """Claim-intent marker, keyed PER SLICE: each slice of a
        multislice notebook claims its own placeholder, so slice 0's
        marker must not suppress slice 1's claim. Slice 0 keeps the bare
        CLAIMED_FROM name (the single-slice contract tests/users see)."""
        return CLAIMED_FROM if slice_id == 0 else f"{CLAIMED_FROM}.{slice_id}"

    def _maybe_claim_warm_slice(
        self, obj: dict, nb: Notebook, topo, slice_id: int = 0
    ) -> None:
        """Claim a warm SlicePool placeholder BEFORE the slice scales up,
        so the freed cards and warm nodes are available when the slice
        pods first schedule (``controller/slicepool.py``). The caller only
        invokes this on a 0→N replica transition (creation with no lock,
        lock release, or resume) — never the steady-state reconcile path."""
        marker = self._claim_marker_key(slice_id)
        pools = self.client.list("SlicePool", nb.namespace)
        if not pools:
            # Namespace doesn't use pools (the common case): return before
            # the idempotence GET below — an extra read per scale-up
            # reconcile on the no-pool spawn path is measurable wire
            # latency for nothing. Keep metrics quiet too.
            return
        # One transition, one claim per slice: a prior pass may have
        # claimed but its replica update is not visible yet (stale cache
        # read, or the STS write failed after the claim) — the claim
        # marker on a FRESH read is the intent record that stops a second
        # placeholder being drained for the same scale-up. Markers are
        # cleared whenever the notebook is stopped
        # (_clear_claim_annotations), so a resume claims again.
        try:
            fresh = self.client.get("Notebook", nb.name, nb.namespace)
        except NotFoundError:
            return
        if marker in obj_util.annotations_of(fresh):
            return
        pool = claim_warm_slice(
            self.client, nb.namespace, topo, recorder=self.recorder,
            notebook=obj, now=self.clock(), pools=pools,
            # Bound the fenced candidate walk: this runs inside the
            # single-threaded reconcile loop, and a claim stampede must
            # cost one scale-up its placeholder, not wedge every queued
            # reconcile behind the walk.
            deadline=time.perf_counter() + 5.0,
        )
        if not pool:
            self.metrics.pool_claim_misses_total.inc()
            return
        self.metrics.pool_claims_total.inc()

        def record():
            fresh = self.client.get("Notebook", nb.name, nb.namespace)
            if obj_util.annotations_of(fresh).get(marker) != pool:
                obj_util.set_annotation(fresh, marker, pool)
                self.client.update(fresh)

        retry_on_conflict(record)

    def _clear_claim_annotations(self, obj: dict, nb: Notebook) -> None:
        """A stopped notebook holds no slice capacity: drop the
        claimed-from-pool markers (every per-slice key) so the next 0→N
        transition (resume) claims fresh warm slices, while repeated
        reconciles of the SAME transition stay idempotent
        (_maybe_claim_warm_slice skips on the marker)."""
        def markers(o) -> list[str]:
            return [
                k for k in obj_util.annotations_of(o)
                if k == CLAIMED_FROM or k.startswith(f"{CLAIMED_FROM}.")
            ]

        # Steady-state cheapness: most stopped notebooks carry no marker;
        # decide on the already-fetched object before paying a fresh GET.
        if not markers(obj):
            return

        def clear():
            try:
                fresh = self.client.get("Notebook", nb.name, nb.namespace)
            except NotFoundError:
                return
            found = markers(fresh)
            if found:
                for k in found:
                    obj_util.remove_annotation(fresh, k)
                self.client.update(fresh)

        retry_on_conflict(clear)

    # ------------------------------------------------------------------
    def _reconcile_statefulset(
        self, owner: dict, desired: dict, existing: Optional[dict]
    ) -> bool:
        """Create-or-update (``existing`` prefetched by the caller — one
        GET serves both the claim probe and this); True when created."""
        name = obj_util.name_of(desired)
        if existing is None:
            obj_util.set_controller_reference(owner, desired)
            try:
                self.client.create(desired)
            except Exception:
                self.metrics.create_failed_total.inc()
                raise
            return True
        if not obj_util.is_controlled_by(owner, existing):
            # E.g. notebook "foo" (sliceCount 2) vs a sibling notebook
            # literally named "foo-s1": both would claim STS "foo-s1".
            # Never adopt — two reconcilers would fight over one object.
            self.recorder.eventf(
                owner, "Warning", "StatefulSetConflict",
                f"StatefulSet {name} exists but is not controlled by this "
                "Notebook; refusing to adopt it (name collision?)",
            )
            return False
        if helper.copy_statefulset_fields(desired, existing):
            # Conflict-retried: aborting here after a warm-slice claim
            # would re-enter the 0→N transition next reconcile and consume
            # a SECOND placeholder for the same scale-up.
            def write():
                fresh = self.client.get(
                    "StatefulSet", name, obj_util.namespace_of(desired)
                )
                if helper.copy_statefulset_fields(desired, fresh):
                    self.client.update(fresh)

            retry_on_conflict(write)
        return False

    def _prune_stale_slice_sts(self, nb: Notebook, slice_count: int) -> None:
        """Delete per-slice StatefulSets beyond the current sliceCount (a
        shrink while stopped; the validating webhook blocks live changes)."""
        expected = set(slice_sts_names(nb.name, slice_count))
        for sts in self.client.list(
            "StatefulSet", nb.namespace, {ann.NOTEBOOK_NAME_LABEL: nb.name}
        ):
            name = obj_util.name_of(sts)
            if name in expected:
                continue
            if not obj_util.is_controlled_by(nb.obj, sts):
                # Mirror _reconcile_statefulset's adoption guard: a
                # user-created STS that merely carries our name label must
                # not be deleted out from under its owner.
                self.recorder.eventf(
                    nb.obj, "Warning", "StatefulSetConflict",
                    f"StatefulSet {name} carries label "
                    f"{ann.NOTEBOOK_NAME_LABEL}={nb.name} but is not "
                    "controlled by this Notebook; refusing to prune it",
                )
                continue
            try:
                self.client.delete("StatefulSet", name, nb.namespace)
            except NotFoundError:
                pass

    # ------------------------------------------------------------------
    def _slice_pods(self, nb: Notebook) -> list[dict]:
        # Server-side label selection: this runs in every reconcile, and a
        # full-namespace pod list would be O(namespace) on a real apiserver.
        pods = self.client.list(
            "Pod", nb.namespace, {ann.NOTEBOOK_NAME_LABEL: nb.name}
        )
        return sorted(pods, key=obj_util.name_of)

    def _update_status(self, nb: Notebook, slice_topo: Optional[SliceTopology]) -> None:
        """Mirror pod state onto the Notebook (reference
        createNotebookStatus :315-374), extended with the slice's status
        under ``status.gpu``."""
        pods = self._slice_pods(nb)
        pod0 = next((p for p in pods if obj_util.name_of(p).endswith("-0")), None)

        status: dict = {}
        ready_hosts = 0
        for pod in pods:
            if _pod_ready(pod):
                ready_hosts += 1
        status["readyReplicas"] = ready_hosts

        pod_conditions: list = []
        if pod0 is not None:
            # Mirror pod-0 conditions (the reference mirrors its single pod).
            pod_conditions = pod0.get("status", {}).get("conditions", [])
            for cs in pod0.get("status", {}).get("containerStatuses", []):
                if cs.get("name") == nb.name:
                    status["containerState"] = cs.get("state", {})
                    break

        if slice_topo is not None:
            slice_count = nb.gpu.slice_count
            hosts = slice_topo.hosts * slice_count  # total pods
            interrupted = any(
                p.get("status", {}).get("phase") == "Failed" for p in pods
            ) or ann.TPU_SLICE_INTERRUPTED in nb.annotations
            if nb.stopped:
                health = "Stopped"
            elif interrupted:
                health = "Interrupted"
            elif ready_hosts == hosts:
                health = "Healthy"
            else:
                health = "Forming"
            status["gpu"] = {
                "hosts": hosts,
                "readyHosts": ready_hosts,
                "sliceHealth": health,
                "acceleratorType": slice_topo.accelerator_type,
            }
            if slice_count > 1:
                status["gpu"]["slices"] = slice_count
                status["gpu"]["hostsPerSlice"] = slice_topo.hosts
            if hosts > 1:
                status["gpu"]["jaxCoordinator"] = (
                    f"{slice_sts_name(nb.name, 0)}-0."
                    f"{headless_service_name(nb.name)}."
                    f"{nb.namespace}.svc.{self.config.cluster_domain}"
                    f":{JAX_COORDINATOR_PORT}"
                )
            prof = ann.parse_profiling_port(
                nb.annotations.get(ann.TPU_PROFILING_PORT)
            )
            if prof is not None:
                # Worker 0's profiler server listens on this port (the
                # webhook projects it into the env).
                status["gpu"]["profilingServer"] = (
                    f"{slice_sts_name(nb.name, 0)}-0."
                    f"{headless_service_name(nb.name)}."
                    f"{nb.namespace}.svc.{self.config.cluster_domain}:{prof}"
                )
            serving = ann.parse_profiling_port(
                nb.annotations.get(ann.TPU_SERVING_PORT)
            )
            if serving is not None:
                # Worker 0 binds the HTTP inference endpoint on this port
                # (models/server.py serving_port_from_env).
                status["gpu"]["servingEndpoint"] = (
                    f"{slice_sts_name(nb.name, 0)}-0."
                    f"{headless_service_name(nb.name)}."
                    f"{nb.namespace}.svc.{self.config.cluster_domain}"
                    f":{serving}"
                )
            if health == "Healthy":
                self._observe_slice_ready(nb)

        def write():
            # Merge against the FRESH object's conditions: a condition set
            # earlier in this reconcile (e.g. GPUTopologyValid) must survive
            # the status rewrite, or the two writers oscillate forever.
            fresh = self.client.get("Notebook", nb.name, nb.namespace)
            merged = dict(status)
            merged["conditions"] = _merge_pod_conditions(
                fresh.get("status", {}).get("conditions", []), pod_conditions
            )
            if fresh.get("status", {}) == merged:
                return
            fresh["status"] = merged
            self.client.update_status(fresh)

        retry_on_conflict(write)

    def _observe_slice_ready(self, nb: Notebook) -> None:
        key = (nb.namespace, nb.name)
        if key in self._ready_observed:
            return
        self._ready_observed.add(key)
        created = nb.obj.get("metadata", {}).get("creationTimestamp", "")
        created_s = obj_util.parse_timestamp(created)
        if created_s is None:
            return
        elapsed = max(0.0, self.clock() - created_s)
        self.metrics.slice_ready_seconds.observe(elapsed)

    # ------------------------------------------------------------------
    def _handle_restart(self, nb: Notebook, slice_topo: Optional[SliceTopology]) -> None:
        """Restart annotation → delete every slice pod, then clear it
        (reference :259-294 deletes the single pod; a GPU slice restarts
        as a unit — deleting only one host would wedge the process group)."""
        if nb.annotations.get(ann.RESTART) != "true":
            return
        deleted = 0
        for pod in self._slice_pods(nb):
            try:
                self.client.delete("Pod", obj_util.name_of(pod), nb.namespace)
                deleted += 1
            except NotFoundError:
                pass

        def clear():
            fresh = self.client.get("Notebook", nb.name, nb.namespace)
            if obj_util.remove_annotation(fresh, ann.RESTART):
                self.client.update(fresh)

        retry_on_conflict(clear)
        self.recorder.eventf(
            nb.obj, "Normal", "NotebookRestarted",
            f"All {max(1, deleted)} slice pod(s) deleted for restart",
        )

    # ------------------------------------------------------------------
    def _reemit_pod_events(self, nb: Notebook, slice_topo: Optional[SliceTopology]) -> None:
        """Surface Warning events from slice pods on the Notebook itself
        (reference :99-126 re-emits via nbNameFromInvolvedObject).

        Dedup is a lastSeen CURSOR on the Notebook (the newest Event
        resourceVersion already processed): ONE field-indexed Event read
        per reconcile and zero writes to Event objects — writing dedup
        marks onto Events (the previous design) raced apiserver Event
        TTL/series aggregation and cost one update per surfaced event.
        The cursor lives on the Notebook, so a restarted controller
        resumes where it left off instead of re-emitting history.
        """
        slice_count = nb.gpu.slice_count if slice_topo is not None else 1
        pod_names = {
            f"{sts}-{i}"
            for sts in slice_sts_names(nb.name, slice_count)
            for i in range(slice_topo.hosts if slice_topo else 1)
        }
        raw_cursor = nb.annotations.get(ann.LAST_SEEN_EVENT_RV, "")
        cursor = _cursor_token(raw_cursor)
        events = self.client.list(
            "Event", nb.namespace,
            field_selector={"involvedObject.kind": "Pod"},
        )
        # Floor token: sorts below BOTH regimes, so priming with no events
        # still writes a non-empty annotation (its presence IS the primed
        # marker) without blocking either regime's first real event.
        max_seen = cursor or _CURSOR_FLOOR
        emitted = False
        priming = not raw_cursor
        # Sticky regime: once the cursor holds an int (etcd) or ts
        # (opaque-rv fallback) token, events from the OTHER regime are
        # skipped symmetrically — string order must never promote the
        # cursor across regimes. Without this, ONE opaque rv that happens
        # to parse as an integer would lift the cursor into the int regime
        # (ints sort above every '.'-prefixed ts token) and permanently
        # suppress all subsequent timestamp-token events. An unpinned
        # cursor (fresh/floor) pins to the MAJORITY regime of the visible
        # events, so the same single anomaly cannot pin the wrong regime
        # at priming either.
        regime = _token_regime(cursor)
        if not regime and events:
            votes = {"int": 0, "ts": 0}
            for e in events:
                votes[_token_regime(_event_token(e))] += 1
            regime = "int" if votes["int"] >= votes["ts"] else "ts"
        for event in sorted(events, key=_event_token):
            rv = _event_token(event)
            if regime and _token_regime(rv) != regime:
                continue
            if rv <= cursor:
                continue
            max_seen = max(max_seen, rv)
            if priming:
                # First sight of this notebook (fresh create OR controller
                # upgraded from the old per-Event-mark dedup): prime the
                # cursor past existing history instead of re-emitting it —
                # the notebook's own pods cannot have pre-creation events
                # worth surfacing, and upgrades must not replay the fleet's
                # retained Warning history as a duplicate burst.
                continue
            inv = event.get("involvedObject", {})
            if event.get("type") != "Warning" or inv.get("name") not in pod_names:
                continue
            self.recorder.eventf(
                nb.obj, "Warning", event.get("reason", "PodEvent"),
                f"[{inv.get('name')}] {event.get('message', '')}",
            )
            emitted = True
        # Persist the cursor when something was surfaced, or once to prime
        # (even at 0 — the annotation's presence IS the primed marker).
        # Otherwise skip the write: unrelated namespace events are cheap to
        # re-filter next reconcile, and writing would make N notebooks each
        # update themselves whenever ANY pod in the namespace logs an event.
        if priming or (emitted and max_seen > cursor):
            def advance():
                try:
                    fresh = self.client.get("Notebook", nb.name, nb.namespace)
                except NotFoundError:
                    return  # deleted mid-reconcile — nothing to advance
                # Monotonic merge: another worker may have advanced further.
                fresh_raw = obj_util.annotations_of(fresh).get(
                    ann.LAST_SEEN_EVENT_RV, ""
                )
                if fresh_raw and _cursor_token(fresh_raw) >= max_seen:
                    return
                obj_util.set_annotation(
                    fresh, ann.LAST_SEEN_EVENT_RV, max_seen
                )
                self.client.update(fresh)

            retry_on_conflict(advance)

    def _set_condition(
        self, nb: Notebook, ctype: str, cstatus: str, reason: str, message: str
    ) -> None:
        def write():
            fresh = self.client.get("Notebook", nb.name, nb.namespace)
            obj_util.set_condition(
                fresh,
                {"type": ctype, "status": cstatus, "reason": reason, "message": message},
            )
            self.client.update_status(fresh)

        retry_on_conflict(write)


# ---------------------------------------------------------------------------
# Spec generation (pure functions)


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


# ---------------------------------------------------------------------------
# Watch map functions


def _pod_to_notebook(ev) -> list[Request]:
    labels = ev.object.get("metadata", {}).get("labels", {})
    name = labels.get(ann.NOTEBOOK_NAME_LABEL)
    if name:
        return [Request(name, ev.namespace)]
    return []


def _event_to_notebook(ev) -> list[Request]:
    """Map pod Events to their Notebook: pod "{nb}-{ordinal}" → nb
    (reference nbNameFromInvolvedObject :705)."""
    inv = ev.object.get("involvedObject", {})
    if inv.get("kind") != "Pod":
        return []
    name = inv.get("name", "")
    base, _, ordinal = name.rpartition("-")
    if base and ordinal.isdigit():
        requests = [Request(base, ev.namespace)]
        # Multislice pods are "{nb}-s{j}-{i}"; a notebook literally named
        # "{nb}-s{j}" is also possible, so requeue BOTH candidates (a
        # nonexistent name reconciles to a no-op).
        head, _, tail = base.rpartition("-")
        if head and len(tail) > 1 and tail[0] == "s" and tail[1:].isdigit():
            requests.append(Request(head, ev.namespace))
        return requests
    return []


def _pod_ready(pod: dict) -> bool:
    for cond in pod.get("status", {}).get("conditions", []):
        if cond.get("type") == "Ready":
            return cond.get("status") == "True"
    return False


def _merge_pod_conditions(existing: list, pod_conditions: list) -> list:
    """Mirror pod conditions by type (reference PodCondToNotebookCond :376)."""
    merged = {c.get("type"): c for c in existing}
    for cond in pod_conditions:
        merged[cond.get("type")] = {
            "type": cond.get("type"),
            "status": cond.get("status"),
            **({"reason": cond["reason"]} if cond.get("reason") else {}),
            **({"message": cond["message"]} if cond.get("message") else {}),
            **(
                {"lastTransitionTime": cond["lastTransitionTime"]}
                if cond.get("lastTransitionTime")
                else {}
            ),
        }
    return list(merged.values())
