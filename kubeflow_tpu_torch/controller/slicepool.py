"""SlicePool reconciler: keep warm GPU slices provisioned; serve claims.

The port's own copy of ``kubeflow_tpu/controller/slicepool.py`` over the
GPU slice (``api/slicepool.py``):

- a level-triggered reconcile keeps ``spec.warmReplicas`` (or, for an
  autoscaled pool, its demand-driven target) placeholder StatefulSets a
  pool, with the ``nvidia.com/gpu`` resources and node selector of a
  notebook slice of that shape and an idle container, so nodes stay
  provisioned and the image stays pulled;
- ``claim_warm_slice`` (the Notebook reconciler's 0→N scale-up, the
  gateway's ``WarmSliceReplicaSource``) fences one placeholder with an
  optimistic-concurrency write and deletes it, freeing its cards on warm
  nodes; the pool's next reconcile refills it;
- placeholders are named with a monotonic generation counter, so a refill
  never races the cascade-delete of a claimed StatefulSet's pods.

Claim tokens come from ``secrets``, as the JAX package's do, so no seed
makes two claimants' fences equal.
"""

from __future__ import annotations

import copy
import logging
import secrets
import time
from typing import Callable, Optional

from kubeflow_tpu_torch.api import slicepool as sp
from kubeflow_tpu_torch.api.names import derived_name
from kubeflow_tpu_torch.api.notebook import MAX_NAME_LENGTH
from kubeflow_tpu_torch.k8s import objects as obj_util
from kubeflow_tpu_torch.k8s.client import Client, retry_on_conflict
from kubeflow_tpu_torch.k8s.errors import (
    AlreadyExistsError,
    ConflictError,
    NotFoundError,
)
from kubeflow_tpu_torch.k8s.events import EventRecorder
from kubeflow_tpu_torch.k8s.manager import Manager, Reconciler, Request, Result
from kubeflow_tpu_torch.metrics import Metrics
from kubeflow_tpu_torch.gpu.topology import InvalidTopologyError, SliceTopology

log = logging.getLogger(__name__)

GPU_RESOURCE = "nvidia.com/gpu"


# Shipped by config/manager (deploy.manifests.placeholder_priority_class):
# value < 0 so any default-priority notebook pod preempts placeholder pods.
PLACEHOLDER_PRIORITY_CLASS = "tpu-slicepool-placeholder"


def warm_sts_name(pool_name: str, generation: int) -> str:
    return derived_name(pool_name, f"-warm-{generation}", MAX_NAME_LENGTH)


def generate_warm_statefulset(
    pool: sp.SlicePool, topo: SliceTopology, generation: int
) -> dict:
    """Placeholder slice: real cards + nodeSelector, idle container.

    The container requests the full per-host card count so the scheduler
    (and GKE autoscaler) treat it exactly like a notebook slice; the idle
    command never opens the notebook port, so routing/culling ignore it.
    """
    name = warm_sts_name(pool.name, generation)
    labels = {
        sp.POOL_LABEL: pool.name,
        sp.STATE_LABEL: sp.STATE_WARM,
        sp.ACCELERATOR_LABEL: topo.accelerator_type,
        sp.TOPOLOGY_LABEL: topo.topology_str,
        "statefulset": name,
    }
    container = {
        "name": "warm-placeholder",
        "image": pool.image,
        # The workbench image's shell idles; the image itself is the point
        # (kubelet keeps it pulled on every slice node).
        "command": ["/bin/sh", "-c", "sleep infinity"],
        "resources": {
            "limits": {GPU_RESOURCE: str(topo.chips_per_host)},
            "requests": {GPU_RESOURCE: str(topo.chips_per_host)},
        },
    }
    pod_spec = {
        "containers": [container],
        "nodeSelector": dict(topo.node_selector()),
        "tolerations": [
            {"key": GPU_RESOURCE, "operator": "Exists", "effect": "NoSchedule"}
        ],
        # Negative-priority pods (config/manager ships the PriorityClass):
        # notebook pods (priority 0) PREEMPT placeholders, so a refill that
        # races the claiming notebook's pods for the just-freed nodes can
        # never win — the scheduler evicts it in the notebook's favor, and
        # the warm handoff holds without any claim/refill ordering.
        "priorityClassName": PLACEHOLDER_PRIORITY_CLASS,
    }
    return {
        "apiVersion": "apps/v1",
        "kind": "StatefulSet",
        "metadata": {
            "name": name,
            "namespace": pool.namespace,
            "labels": dict(labels),
        },
        "spec": {
            "replicas": topo.hosts,
            "podManagementPolicy": "Parallel",
            "selector": {"matchLabels": {"statefulset": name}},
            # Placeholders need no DNS, but apiserver validation requires a
            # non-empty governing service name (it need not exist) on
            # k8s <= 1.31; the STS's own name keeps it unique and obvious.
            "serviceName": name,
            "template": {"metadata": {"labels": labels}, "spec": pod_spec},
        },
    }


def _sts_ready(sts: dict) -> bool:
    status = sts.get("status", {})
    want = sts.get("spec", {}).get("replicas", 0)
    return want > 0 and status.get("readyReplicas", 0) >= want


class ClaimLost(Exception):
    """Another claimant won this placeholder between our read and our
    write. Raised per candidate by the fenced claim; ``claim_warm_slice``
    catches it and walks on to the next candidate, so two racing claimants
    end up on DISTINCT slices (or one takes a clean miss) — never both
    holding the same one."""


def _claim_candidate(client: Client, chosen: dict, claimant: str) -> None:
    """Atomically take ownership of one placeholder, then delete it.

    The fence is an optimistic-concurrency update: we re-read the
    StatefulSet, reject it if another claimant's CLAIMED_BY fence is
    already on it, stamp our own, and write it back carrying the read's
    resourceVersion. The apiserver's conflict check makes that write the
    atomic claim — a bare delete is check-then-act, and two in-flight
    claimants (an autoscaler tick and a migration, say) can both "win" it.
    Raises ClaimLost when anyone else got there first at any point.
    """
    name = obj_util.name_of(chosen)
    namespace = obj_util.namespace_of(chosen)
    try:
        fresh = client.get("StatefulSet", name, namespace)
    except NotFoundError as err:
        raise ClaimLost(f"{name}: placeholder already deleted") from err
    owner = obj_util.annotations_of(fresh).get(sp.CLAIMED_BY)
    if owner and owner != claimant:
        raise ClaimLost(f"{name}: fenced by {owner}")
    obj_util.set_annotation(fresh, sp.CLAIMED_BY, claimant)
    try:
        client.update(fresh)
    except (ConflictError, NotFoundError) as err:
        raise ClaimLost(f"{name}: fence write lost ({err})") from err
    try:
        client.delete("StatefulSet", name, namespace)
    except NotFoundError as err:
        # Deleted despite a won fence (e.g. an out-of-band GC): the slice
        # is gone either way — surface it as a lost claim, not a success.
        raise ClaimLost(f"{name}: deleted after fence") from err


def claim_warm_slice(
    client: Client,
    namespace: str,
    topo: SliceTopology,
    recorder: Optional[EventRecorder] = None,
    notebook: Optional[dict] = None,
    now: Optional[float] = None,
    pools: Optional[list] = None,
    deadline: Optional[float] = None,
    claimant: Optional[str] = None,
) -> Optional[str]:
    """Claim one warm placeholder matching (accelerator, topology).

    Returns the pool name, or None when no matching warm slice exists.
    Prefers an all-Ready placeholder (nodes provisioned AND image pulled);
    falls back to a still-warming one — even a partially-provisioned
    placeholder beats a cold node-pool scale-up. Deleting the StatefulSet
    cascades to its pods, releasing cards for the notebook's pods.

    Each candidate is taken through the CLAIMED_BY fence (see
    ``_claim_candidate``): concurrent claimants — recovery escalation, a
    migration, the fleet autoscaler — conflict-retry onto distinct slices
    instead of double-claiming one. ``claimant`` names this claim in the
    fence annotation; a fresh random identity is minted when omitted.

    ``deadline`` (a ``time.perf_counter()`` instant) bounds the candidate
    walk: a fleet-wide delete-race pileup or a crawling apiserver turns
    into a clean miss instead of wedging the caller — the gateway's
    autoscaler treats that miss as a claim failure and backs off.

    Demand signals for the autoscaler: a successful claim stamps
    LAST_CLAIM on the owning pool; a miss stamps LAST_MISS and increments
    MISS_COUNT on every topology-matching AUTOSCALED pool in the namespace
    (callers pass ``now``, and may pass a prefetched ``pools`` list to
    avoid a second SlicePool list on the spawn path). Fixed-size pools
    never read the signals, so they are never written.
    """
    candidates = client.list(
        "StatefulSet",
        namespace,
        label_selector={
            sp.STATE_LABEL: sp.STATE_WARM,
            sp.ACCELERATOR_LABEL: topo.accelerator_type,
            sp.TOPOLOGY_LABEL: topo.topology_str,
        },
    )
    # Ready placeholders first, then still-warming ones; on a lost claim
    # race (a concurrent claimant's fence or delete got there first) fall
    # through to the next candidate instead of going cold while warm
    # capacity remains.
    ordered = sorted(candidates, key=lambda s: not _sts_ready(s))
    claimant = claimant or f"claim-{secrets.token_hex(4)}"
    for chosen in ordered:
        if deadline is not None and time.perf_counter() >= deadline:
            return None  # bounded claim: a timed-out walk is a miss
        pool_name = obj_util.labels_of(chosen).get(sp.POOL_LABEL, "")
        try:
            _claim_candidate(client, chosen, claimant)
        except ClaimLost as lost:
            log.info("warm-slice claim by %s moved on: %s", claimant, lost)
            continue
        if recorder is not None and notebook is not None:
            recorder.eventf(
                notebook, "Normal", "ClaimedWarmSlice",
                f"Claimed warm slice {obj_util.name_of(chosen)} from pool "
                f"{pool_name} ({topo.accelerator_type})",
            )
        if now is not None and pool_name:
            _stamp(client, namespace, [pool_name], sp.LAST_CLAIM, now)
        return pool_name or None
    if now is not None:
        if pools is None:
            pools = client.list("SlicePool", namespace)
        matching = [
            obj_util.name_of(p)
            for p in pools
            if _pool_matches(p, topo)
        ]
        _stamp(
            client, namespace, matching, sp.LAST_MISS, now,
            count_key=sp.MISS_COUNT,
        )
    return None


def _pool_matches(pool_obj: dict, topo: SliceTopology) -> bool:
    pool = sp.SlicePool(pool_obj)
    if pool.autoscale is None:
        return False  # fixed pools never read demand signals
    try:
        pt = pool.gpu.slice_topology()
    except Exception:
        return False
    return (
        pt.accelerator_type == topo.accelerator_type
        and pt.topology_str == topo.topology_str
    )


def _stamp(
    client: Client, namespace: str, pool_names: list, key: str, now: float,
    count_key: Optional[str] = None,
) -> None:
    """Demand-signal write. Conflicts are RETRIED (the usual conflicting
    writer is the pool reconciler updating status — losing the race must
    not lose the miss/claim signal); only a deleted pool is skipped. The
    claim-side autoscale gate lives in _pool_matches for misses; claims
    stamp only autoscaled pools too. ``count_key`` additionally increments
    a monotonic counter so N concurrent signals count as N."""
    for name in pool_names:

        def write(name=name):
            try:
                pool = client.get("SlicePool", name, namespace)
            except NotFoundError:
                return
            if sp.SlicePool(pool).autoscale is None:
                return  # nothing reads signals on fixed pools
            obj_util.set_annotation(pool, key, str(now))
            if count_key is not None:
                anns = obj_util.annotations_of(pool)
                try:
                    seen = int(anns.get(count_key, "0"))
                except ValueError:
                    seen = 0
                obj_util.set_annotation(pool, count_key, str(seen + 1))
            client.update(pool)

        retry_on_conflict(write)


class SlicePoolReconciler(Reconciler):
    """Maintains each pool's placeholder StatefulSets and status."""

    def __init__(
        self,
        client: Client,
        metrics: Optional[Metrics] = None,
        recorder: Optional[EventRecorder] = None,
        clock: Optional[Callable[[], float]] = None,
    ):
        self.client = client
        self.metrics = metrics
        self.recorder = recorder or EventRecorder(client)
        self.clock = clock or time.time

    def register(self, manager: Manager) -> None:
        manager.register(
            self,
            for_kind="SlicePool",
            owns=("StatefulSet",),
            name="SlicePoolReconciler",
        )

    def reconcile(self, req: Request) -> Result:
        try:
            obj = self.client.get("SlicePool", req.name, req.namespace)
        except NotFoundError:
            self._drop_gauge(req.name)
            return Result()  # placeholders go via ownerReference GC
        if "deletionTimestamp" in obj["metadata"]:
            self._drop_gauge(req.name)
            return Result()
        pool = sp.SlicePool(obj)

        try:
            topo = pool.gpu.slice_topology()
        except InvalidTopologyError as err:
            self.recorder.eventf(obj, "Warning", "InvalidGPUTopology", str(err))
            pool.status["conditions"] = [
                {
                    "type": "TopologyValid",
                    "status": "False",
                    "reason": "InvalidTopology",
                    "message": str(err),
                }
            ]
            self._write_status(obj)
            return Result()

        warm_target, requeue, scale_status = self._warm_target(pool)

        owned = [
            s
            for s in self.client.list(
                "StatefulSet", pool.namespace,
                label_selector={sp.POOL_LABEL: pool.name},
            )
            if obj_util.is_controlled_by(obj, s)
        ]
        # Refill names never reuse a generation — not even a deleted one
        # (on a real apiserver the claimed StatefulSet lingers while its
        # cascade-delete runs; recreating the same name would fail). The
        # high-water mark persists in status.
        next_gen = max(
            int(pool.status.get("generation", 0)),
            1 + max((_generation_of(s) for s in owned), default=-1),
        )
        changed = False
        while len(owned) < warm_target:
            desired = generate_warm_statefulset(pool, topo, next_gen)
            obj_util.set_controller_reference(obj, desired)
            try:
                created = self.client.create(desired)
                owned.append(created)
                changed = True
            except AlreadyExistsError:
                pass  # stale cache; the next event re-reconciles
            next_gen += 1
        # Scale-down: retire the newest (least likely to be fully warm).
        overs = sorted(owned, key=_generation_of)[warm_target:]
        for extra in overs:
            try:
                self.client.delete(
                    "StatefulSet", obj_util.name_of(extra), pool.namespace
                )
                changed = True
            except NotFoundError:
                pass
        kept = sorted(owned, key=_generation_of)[:warm_target]

        ready = sum(1 for s in kept if _sts_ready(s))
        pool.status.update(
            {
                "generation": next_gen,
                "warmReplicas": len(kept),
                "readyReplicas": ready,
                "conditions": [
                    {
                        "type": "TopologyValid",
                        "status": "True",
                        "reason": "Resolved",
                        "message": f"{topo.accelerator_type} ({topo.hosts} hosts)",
                    }
                ],
                **scale_status,
            }
        )
        self._write_status(obj)
        if self.metrics is not None:
            self.metrics.pool_warm_ready.labels(pool.name).set(ready)
        if changed:
            log.info(
                "slicepool %s/%s: %d warm (%d ready)",
                pool.namespace, pool.name, len(kept), ready,
            )
        return Result(requeue_after=requeue)

    def _write_status(self, pool_obj: dict) -> None:
        """Push this reconcile's computed status, retrying conflicts.

        The usual concurrent writer is claim_warm_slice stamping demand
        annotations — a bare update_status here would lose that race with
        a 409 and abort the whole reconcile mid-transition. The computed
        status is authoritative for this reconcile, so a retry re-reads
        only the resourceVersion, not the decision."""
        desired = copy.deepcopy(pool_obj.get("status", {}))
        name = obj_util.name_of(pool_obj)
        namespace = obj_util.namespace_of(pool_obj)

        def write():
            try:
                fresh = self.client.get("SlicePool", name, namespace)
            except NotFoundError:
                return
            fresh["status"] = desired
            self.client.update_status(fresh)

        retry_on_conflict(write)

    def _warm_target(self, pool: sp.SlicePool) -> tuple[int, float, dict]:
        """(warm target, requeue seconds, status fields).

        Fixed pools: spec.warmReplicas, no requeue. Autoscaled pools: the
        target persists in status and moves one step per reconcile — up
        when a miss postdates the last scale event (demand outran the
        pool), down after scaleDownAfterSeconds with no claim/miss (the
        periodic requeue is what notices pure idleness).
        """
        auto = pool.autoscale
        if auto is None:
            # A pool switched back to fixed sizing must not keep exporting
            # (or later resurrect) autoscaler state — including the demand
            # ANNOTATIONS, or a re-enable would read a stale miss counter
            # against a fresh missCountSeen and scale up on dead demand.
            for key in ("autoscaleTarget", "lastScaleTime", "missCountSeen"):
                pool.status.pop(key, None)
            self._clear_demand_annotations(pool)
            return pool.warm_replicas, 0.0, {}
        lo, hi = auto["min"], auto["max"]
        cooldown = auto["scaleDownAfterSeconds"]
        now = self.clock()
        target = int(pool.status.get("autoscaleTarget", lo))
        target = max(lo, min(hi, target))
        last_scale = float(pool.status.get("lastScaleTime", 0))

        def stamp(key):
            value = pool.obj.get("metadata", {}).get("annotations", {}).get(key)
            try:
                return float(value)
            except (TypeError, ValueError):
                return 0.0

        last_miss, last_claim = stamp(sp.LAST_MISS), stamp(sp.LAST_CLAIM)
        # Misses are a COUNTER so N concurrent cold spawns grow the target
        # by N in one reconcile; the timestamps only feed idle detection.
        miss_count = int(stamp(sp.MISS_COUNT))
        seen = int(pool.status.get("missCountSeen", 0))
        fresh_misses = max(0, miss_count - seen)
        if fresh_misses and target < hi:
            target = min(hi, target + fresh_misses)
            last_scale = now
        elif (
            target > lo
            and now - max(last_miss, last_claim, last_scale) >= cooldown
        ):
            target -= 1
            last_scale = now
        return target, float(cooldown), {
            "autoscaleTarget": target,
            "lastScaleTime": last_scale,
            "missCountSeen": miss_count,
        }

    def _clear_demand_annotations(self, pool: sp.SlicePool) -> None:
        keys = (sp.LAST_MISS, sp.LAST_CLAIM, sp.MISS_COUNT)
        anns = pool.obj.get("metadata", {}).get("annotations", {})
        if not any(k in anns for k in keys):
            return

        def write():
            try:
                fresh = self.client.get("SlicePool", pool.name, pool.namespace)
            except NotFoundError:
                return
            removed = [obj_util.remove_annotation(fresh, k) for k in keys]
            if any(removed):  # list, not genexpr: every key must be removed
                self.client.update(fresh)

        retry_on_conflict(write)

    def _drop_gauge(self, pool_name: str) -> None:
        """A deleted pool must not keep exporting its last warm count."""
        if self.metrics is None:
            return
        try:
            self.metrics.pool_warm_ready.remove(pool_name)
        except KeyError:
            pass  # never set for this pool


def _generation_of(sts: dict) -> int:
    name = obj_util.name_of(sts)
    try:
        return int(name.rsplit("-", 1)[1])
    except (IndexError, ValueError):
        return 0
