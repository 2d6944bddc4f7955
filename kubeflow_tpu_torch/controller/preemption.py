"""Slice health / preemption recovery controller.

The port's own copy of ``kubeflow_tpu/controller/preemption.py`` over the
GPU slice (``spec.gpu``). GPU slices on spot or maintenance-window
capacity lose hosts without warning; the reference has no analogue.
Design:

- Watch slice pods. A pod that dies with a DisruptionTarget condition or a
  Preempted/Evicted reason marks the whole Notebook ``SliceInterrupted``
  (condition + annotation + Warning event) — a partial slice is useless, so
  interruption is a slice-level state, not a pod-level one.
- Recovery is level-triggered AND deadline-bounded. The failed pod is
  deleted so the StatefulSet controller (FakeKubelet in tests, kubelet in
  prod) recreates it, and the reconciler polls on a timer (elapsed-based
  backoff, SliceRecoveryProgress events with ready/total host counts)
  instead of waiting for incidental Pod events that may never come.
- Past ``RecoveryConfig.deadline_s`` the controller ESCALATES: claim a warm
  placeholder from a matching SlicePool (frees healthy provisioned nodes for
  the stuck replacement pods), or — no warm capacity — delete the slice
  StatefulSets so the scheduler retries placement from scratch. Each
  escalation re-arms the deadline.
- After ``max_escalations`` the interruption goes TERMINAL: a
  ``SliceRecoveryFailed`` condition + Warning event, then only a long idle
  requeue — a stuck slice must be visible, not silently retried forever,
  and must not burn API calls.
- When every host is Ready again all recovery state clears, a
  ``tpu-last-interruption-duration`` annotation records how long the
  interruption lasted (restore-hint input for runtime/checkpoint.py), the
  recovery-latency histogram observes it, and SliceRecovered is emitted.
  In-notebook state is gone (torch.distributed must re-init) but the
  *capacity* and the user's Jupyter session recover without dashboard
  action.

The ``migration_trigger`` hook is called as JAX's is, and a hook that
raises is logged and swallowed as JAX's is: a caller that must see the
hook's failure records it inside the hook.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Callable, Optional

from kubeflow_tpu_torch.api import annotations as ann
from kubeflow_tpu_torch.api.notebook import Notebook
from kubeflow_tpu_torch.controller.notebook import slice_sts_names
from kubeflow_tpu_torch.controller.slicepool import claim_warm_slice
from kubeflow_tpu_torch.k8s import objects as obj_util
from kubeflow_tpu_torch.k8s.client import Client, retry_on_conflict
from kubeflow_tpu_torch.k8s.errors import NotFoundError
from kubeflow_tpu_torch.k8s.events import EventRecorder
from kubeflow_tpu_torch.k8s.manager import Manager, Reconciler, Request, Result
from kubeflow_tpu_torch.metrics import Metrics
from kubeflow_tpu_torch.observability import tracing
from kubeflow_tpu_torch.webhook.gpu_env import termination_grace_seconds

log = logging.getLogger(__name__)

_PREEMPTION_REASONS = {"Preempted", "Evicted", "TerminationByKubernetes"}

RECOVERY_FAILED_CONDITION = "SliceRecoveryFailed"

# Annotations owned by this controller; cleared together on recovery (and on
# stop — a stopped notebook holds no slice, so interruption state is stale).
_RECOVERY_ANNOTATIONS = (
    ann.TPU_SLICE_INTERRUPTED,
    ann.TPU_RECOVERY_STARTED,
    ann.TPU_RECOVERY_ESCALATIONS,
    ann.TPU_RECOVERY_LAST_ESCALATION,
)


@dataclass
class RecoveryConfig:
    """Env knobs for the recovery escalation state machine, named and
    defaulted like CullerConfig.from_env (culling_controller.go:534-568
    style: one env var per field, safe defaults)."""

    # How long a recovery phase may poll before escalating.
    deadline_s: float = 300.0
    # First poll interval after an interruption (backs off from here).
    poll_initial_s: float = 5.0
    # Poll interval ceiling while waiting within the deadline.
    poll_max_s: float = 60.0
    # Warm-claim / STS-recreate attempts before going terminal.
    max_escalations: int = 2
    # Requeue period once terminal: still level-triggered (capacity coming
    # back recovers the slice), but no longer burning API calls.
    terminal_requeue_s: float = 1800.0
    # Bound on a single warm-pool claim walk during escalation: the ladder
    # must keep moving (to STS recreate) even if the pool listing is slow
    # or every candidate is being fenced away by concurrent claimants.
    claim_deadline_s: float = 5.0

    @classmethod
    def from_env(cls, env: dict) -> "RecoveryConfig":
        return cls(
            deadline_s=float(env.get("SLICE_RECOVERY_DEADLINE_SECONDS", "300")),
            poll_initial_s=float(env.get("SLICE_RECOVERY_POLL_SECONDS", "5")),
            poll_max_s=float(env.get("SLICE_RECOVERY_POLL_MAX_SECONDS", "60")),
            max_escalations=int(env.get("SLICE_RECOVERY_MAX_ESCALATIONS", "2")),
            terminal_requeue_s=float(
                env.get("SLICE_RECOVERY_TERMINAL_REQUEUE_SECONDS", "1800")
            ),
            claim_deadline_s=float(
                env.get("SLICE_RECOVERY_CLAIM_DEADLINE_SECONDS", "5")
            ),
        )


def _pod_preempted(pod: dict) -> Optional[str]:
    status = pod.get("status", {})
    if status.get("reason") in _PREEMPTION_REASONS:
        return status.get("reason")
    for cond in status.get("conditions", []):
        if cond.get("type") == "DisruptionTarget" and cond.get("status") == "True":
            return cond.get("reason", "DisruptionTarget")
    if status.get("phase") == "Failed":
        return status.get("reason", "PodFailed")
    return None


def _parse_float(value) -> Optional[float]:
    try:
        return float(value)
    except (TypeError, ValueError):
        return None


def _parse_int(value, default: int = 0) -> int:
    try:
        return int(value)
    except (TypeError, ValueError):
        return default


def _condition_true(obj: dict, cond_type: str) -> bool:
    for c in obj.get("status", {}).get("conditions", []):
        if c.get("type") == cond_type:
            return c.get("status") == "True"
    return False


class SliceHealthReconciler(Reconciler):
    def __init__(
        self,
        client: Client,
        metrics: Optional[Metrics] = None,
        recorder: Optional[EventRecorder] = None,
        clock: Optional[Callable[[], float]] = None,
        config: Optional[RecoveryConfig] = None,
        migration_trigger: Optional[Callable[[dict, str], None]] = None,
    ):
        self.client = client
        self.metrics = metrics or Metrics(client)
        self.recorder = recorder or EventRecorder(client, component="slice-health")
        self.clock = clock or time.time
        self.config = config or RecoveryConfig()
        # Optional hook into runtime/migration.py: called with (notebook
        # object, trigger name) when a preemption notice lands or the
        # operator stamps tpu-migrate-now. Fire-and-notify — the reactive
        # ladder below proceeds regardless, so a migration that fails (or
        # a hook that raises) costs nothing the ladder wasn't already
        # going to pay. None (the default) keeps recovery purely reactive.
        self.migration_trigger = migration_trigger

    def register(self, manager: Manager) -> None:
        manager.register(
            self,
            for_kind="Notebook",
            watches=[("Pod", _pod_to_notebook)],
            name="SliceHealth",
        )

    def reconcile(self, req: Request) -> Result:
        # One span per health pass; the recovery-ladder steps below add
        # events/child spans, so an outage reads as a single trace:
        # interruption → polls → escalations → recovered/terminal.
        with tracing.get_tracer("controller").start_span(
            "slice_health.reconcile",
            notebook=req.name, namespace=req.namespace,
        ):
            return self._reconcile(req)

    def _reconcile(self, req: Request) -> Result:
        try:
            obj = self.client.get("Notebook", req.name, req.namespace)
        except NotFoundError:
            return Result()
        nb = Notebook(obj)
        if nb.gpu is None or "deletionTimestamp" in obj["metadata"]:
            return Result()
        if nb.stopped:
            # A stopped notebook holds no slice: interruption/recovery state
            # is stale the moment the STS scales to 0 (but keep the last
            # interruption duration — it still describes a real outage).
            if any(k in nb.annotations for k in _RECOVERY_ANNOTATIONS):
                self._clear_recovery_state(nb)
            return Result()

        now = self.clock()
        if ann.TPU_MIGRATE_NOW in nb.annotations:
            # Operator-requested migration: consume the annotation first
            # (clearing it marks the trigger picked up, and makes a retry
            # an explicit re-stamp rather than an accidental loop), then
            # fire the hook.
            self._consume_migrate_annotation(nb)
            self._fire_migration(obj, "operator")
        pods = self.client.list(
            "Pod", nb.namespace, {ann.NOTEBOOK_NAME_LABEL: nb.name}
        )
        failed = [(p, _pod_preempted(p)) for p in pods]
        failed = [(p, reason) for p, reason in failed if reason]

        if failed:
            state_note = _checkpoint_state_note(nb)
            for pod, reason in failed:
                self.metrics.slice_preemptions_total.inc()
                self.recorder.eventf(
                    obj, "Warning", "SliceInterrupted",
                    f"Host pod {obj_util.name_of(pod)} lost ({reason}); "
                    f"recreating — {state_note}",
                )
                # Delete so the STS/kubelet recreates the host pod.
                try:
                    self.client.delete("Pod", obj_util.name_of(pod), nb.namespace)
                except NotFoundError:
                    pass
            self._mark_interrupted(nb, failed[0][1], now)
            tracing.current_span().add_event("slice_interrupted", {
                "reason": failed[0][1], "pods_lost": len(failed),
            })
            # Proactive path first (save → warm-claim → restore → flip),
            # but the reactive poll below is scheduled unconditionally:
            # a migration that falls back leaves the ladder mid-stride,
            # exactly where it would have been without the attempt.
            self._fire_migration(obj, "preemption-notice")
            # Recovery is now OURS to drive: poll on a timer instead of
            # hoping replacement-pod events keep arriving.
            return Result(requeue_after=self.config.poll_initial_s)

        if ann.TPU_SLICE_INTERRUPTED not in nb.annotations:
            return Result()
        try:
            # ALL hosts of ALL slices must be Ready again (a 2-slice
            # notebook has hosts×2 pods; comparing against one slice's
            # host count would leave the interruption set forever).
            hosts = nb.gpu.slice_topology().hosts * nb.gpu.slice_count
        except Exception:
            return Result()
        ready = sum(1 for p in pods if _pod_ready(p))
        if ready == hosts:
            self._complete_recovery(nb, obj, hosts, now)
            return Result()
        return self._poll_or_escalate(nb, obj, ready, hosts, now)

    # -- proactive migration hand-off --------------------------------------

    def _fire_migration(self, obj: dict, trigger: str) -> None:
        if self.migration_trigger is None:
            return
        try:
            self.migration_trigger(obj, trigger)
        except Exception:
            # Migration is an optimization, never a new failure mode: a
            # hook crash must not take the reactive reconcile down with it.
            log.exception(
                "migration trigger (%s) raised; reactive recovery continues",
                trigger,
            )

    def _consume_migrate_annotation(self, nb: Notebook) -> None:
        def write():
            try:
                fresh = self.client.get("Notebook", nb.name, nb.namespace)
            except NotFoundError:
                return
            if obj_util.remove_annotation(fresh, ann.TPU_MIGRATE_NOW):
                self.client.update(fresh)

        retry_on_conflict(write)

    # -- interruption lifecycle --------------------------------------------

    def _mark_interrupted(self, nb: Notebook, reason: str, now: float) -> None:
        def write():
            fresh = self.client.get("Notebook", nb.name, nb.namespace)
            anns = obj_util.annotations_of(fresh)
            changed = False
            if anns.get(ann.TPU_SLICE_INTERRUPTED) != reason:
                anns[ann.TPU_SLICE_INTERRUPTED] = reason
                changed = True
            # First failure of THIS interruption starts the recovery clock;
            # repeated failures while already interrupted keep the original
            # start (the deadline measures the whole outage, not the last
            # pod flap).
            if ann.TPU_RECOVERY_STARTED not in anns:
                anns[ann.TPU_RECOVERY_STARTED] = str(now)
                changed = True
            if changed:
                self.client.update(fresh)

        retry_on_conflict(write)

    def _poll_or_escalate(
        self, nb: Notebook, obj: dict, ready: int, hosts: int, now: float
    ) -> Result:
        cfg = self.config
        anns = nb.annotations
        if _condition_true(obj, RECOVERY_FAILED_CONDITION):
            # Terminal: stay visible (condition + prior Warning event), stop
            # burning API calls — a long idle requeue still notices capacity
            # that comes back on its own (the ready==hosts path clears it).
            return Result(requeue_after=cfg.terminal_requeue_s)

        started = _parse_float(anns.get(ann.TPU_RECOVERY_STARTED))
        if started is None:
            # Interruption marked by an older controller build: adopt the
            # annotation into the state machine starting now.
            started = now
            self._stamp_recovery_started(nb, now)
        escalations = _parse_int(anns.get(ann.TPU_RECOVERY_ESCALATIONS))
        last_escalation = _parse_float(anns.get(ann.TPU_RECOVERY_LAST_ESCALATION))
        phase_start = max(started, last_escalation or 0.0)
        elapsed = max(0.0, now - phase_start)

        # Message deliberately excludes elapsed time: the EventRecorder
        # dedups on (kind/name/reason/message), so identical polls bump one
        # Event's count instead of spamming new objects.
        self.recorder.eventf(
            obj, "Normal", "SliceRecoveryProgress",
            f"Slice recovering: {ready}/{hosts} hosts Ready "
            f"(escalations used: {escalations}/{cfg.max_escalations})",
        )

        if elapsed < cfg.deadline_s:
            # Elapsed-based backoff needs no stored poll counter: wait about
            # as long as this phase has already waited, clamped to
            # [poll_initial, poll_max] and never past the deadline.
            delay = min(
                max(cfg.poll_initial_s, elapsed),
                cfg.poll_max_s,
                cfg.deadline_s - elapsed,
            )
            return Result(requeue_after=max(delay, 0.001))

        if escalations >= cfg.max_escalations:
            return self._go_terminal(nb, obj, ready, hosts)
        self._escalate(nb, obj, escalations, now)
        return Result(requeue_after=cfg.poll_initial_s)

    def _escalate(
        self, nb: Notebook, obj: dict, escalations: int, now: float
    ) -> None:
        """One escalation step: warm-pool claim, else STS recreate."""
        with tracing.get_tracer("controller").start_span(
            "preemption.escalate", attempt=escalations + 1,
        ) as span:
            self._escalate_step(nb, obj, escalations, now, span)

    def _escalate_step(
        self, nb: Notebook, obj: dict, escalations: int, now: float, span
    ) -> None:
        attempt = escalations + 1
        topo = nb.gpu.slice_topology()
        pool = claim_warm_slice(
            self.client, nb.namespace, topo,
            recorder=self.recorder, notebook=obj, now=now,
            claimant=f"recovery-{nb.namespace}-{nb.name}",
            deadline=time.perf_counter() + self.config.claim_deadline_s,
        )
        if pool is not None:
            # claim_warm_slice already emitted ClaimedWarmSlice; deleting the
            # placeholder freed provisioned warm nodes, so the stuck
            # replacement pods can bind on the next scheduler retry.
            self.recorder.eventf(
                obj, "Warning", "SliceRecoveryEscalated",
                f"Recovery deadline exceeded; claimed a warm slice from pool "
                f"{pool} to free capacity (escalation {attempt})",
            )
        else:
            names = slice_sts_names(nb.name, nb.gpu.slice_count)
            for name in names:
                try:
                    self.client.delete("StatefulSet", name, nb.namespace)
                except NotFoundError:
                    pass
            # An STS recreate TERMINATES the surviving healthy hosts too:
            # say up front how long the kubelet will wait for their
            # emergency checkpoints, so the event explains the extra
            # teardown latency the ladder just signed up for.
            grace = ann.parse_checkpoint_grace(
                nb.annotations.get(ann.TPU_CHECKPOINT_GRACE)
            )
            grace_note = (
                f"; surviving hosts get {termination_grace_seconds(grace)}s "
                "termination grace for an emergency checkpoint"
                if grace is not None else ""
            )
            self.recorder.eventf(
                obj, "Warning", "SliceRecoveryEscalated",
                "Recovery deadline exceeded and no warm slice available; "
                f"recreating StatefulSet(s) {', '.join(names)} for fresh "
                f"placement (escalation {attempt}){grace_note}",
            )
        self.metrics.slice_recovery_escalations_total.inc()
        span.set_attribute(
            "mode", "warm-claim" if pool else "sts-recreate"
        )
        log.warning(
            "slice %s/%s: recovery escalation %d (%s)",
            nb.namespace, nb.name, attempt,
            "warm-claim" if pool else "sts-recreate",
        )

        def write():
            try:
                fresh = self.client.get("Notebook", nb.name, nb.namespace)
            except NotFoundError:
                return
            anns = obj_util.annotations_of(fresh)
            anns[ann.TPU_RECOVERY_ESCALATIONS] = str(attempt)
            anns[ann.TPU_RECOVERY_LAST_ESCALATION] = str(now)
            self.client.update(fresh)

        retry_on_conflict(write)

    def _go_terminal(self, nb: Notebook, obj: dict, ready: int, hosts: int) -> Result:
        cfg = self.config
        self.metrics.slice_recovery_failed_total.inc()

        def write():
            try:
                fresh = self.client.get("Notebook", nb.name, nb.namespace)
            except NotFoundError:
                return
            obj_util.set_condition(fresh, {
                "type": RECOVERY_FAILED_CONDITION,
                "status": "True",
                "reason": "RecoveryDeadlineExceeded",
                "message": (
                    f"slice stuck at {ready}/{hosts} Ready hosts after "
                    f"{cfg.max_escalations} escalations"
                ),
            })
            self.client.update_status(fresh)

        retry_on_conflict(write)
        self.recorder.eventf(
            obj, "Warning", RECOVERY_FAILED_CONDITION,
            f"Giving up active recovery: {ready}/{hosts} hosts Ready after "
            f"{cfg.max_escalations} escalations; will re-check every "
            f"{int(cfg.terminal_requeue_s)}s",
        )
        log.error(
            "slice %s/%s: recovery FAILED terminally (%d/%d hosts)",
            nb.namespace, nb.name, ready, hosts,
        )
        tracing.current_span().record_error(RuntimeError(
            f"recovery terminal: {ready}/{hosts} hosts Ready"
        ))
        return Result(requeue_after=cfg.terminal_requeue_s)

    def _complete_recovery(
        self, nb: Notebook, obj: dict, hosts: int, now: float
    ) -> None:
        started = _parse_float(nb.annotations.get(ann.TPU_RECOVERY_STARTED))
        duration = max(0.0, now - started) if started is not None else None
        if duration is not None:
            self.metrics.slice_recovery_seconds.observe(duration)
        tracing.current_span().add_event("slice_recovered", {
            "hosts": hosts,
            **({"duration_s": round(duration, 3)}
               if duration is not None else {}),
        })
        self._clear_recovery_state(nb, duration=duration)
        if _condition_true(obj, RECOVERY_FAILED_CONDITION):
            # Capacity came back after we went terminal: flip the condition
            # rather than delete it — the transition itself is signal.
            def write():
                try:
                    fresh = self.client.get("Notebook", nb.name, nb.namespace)
                except NotFoundError:
                    return
                obj_util.set_condition(fresh, {
                    "type": RECOVERY_FAILED_CONDITION,
                    "status": "False",
                    "reason": "Recovered",
                    "message": f"all {hosts} hosts Ready again",
                })
                self.client.update_status(fresh)

            retry_on_conflict(write)
        message = f"All {hosts} slice hosts Ready again"
        if duration is not None:
            message += f" after {duration:.0f}s interruption"
        self.recorder.eventf(obj, "Normal", "SliceRecovered", message)

    def _stamp_recovery_started(self, nb: Notebook, now: float) -> None:
        def write():
            try:
                fresh = self.client.get("Notebook", nb.name, nb.namespace)
            except NotFoundError:
                return
            anns = obj_util.annotations_of(fresh)
            if ann.TPU_RECOVERY_STARTED not in anns:
                anns[ann.TPU_RECOVERY_STARTED] = str(now)
                self.client.update(fresh)

        retry_on_conflict(write)

    def _clear_recovery_state(
        self, nb: Notebook, duration: Optional[float] = None
    ) -> None:
        def write():
            try:
                fresh = self.client.get("Notebook", nb.name, nb.namespace)
            except NotFoundError:
                return
            removed = [
                obj_util.remove_annotation(fresh, key)
                for key in _RECOVERY_ANNOTATIONS
            ]
            changed = any(removed)
            if duration is not None:
                anns = obj_util.annotations_of(fresh)
                stamp = f"{duration:.0f}s"
                if anns.get(ann.TPU_LAST_INTERRUPTION_DURATION) != stamp:
                    anns[ann.TPU_LAST_INTERRUPTION_DURATION] = stamp
                    changed = True
            if changed:
                self.client.update(fresh)

        retry_on_conflict(write)


def _checkpoint_state_note(nb: Notebook) -> str:
    """How much in-notebook state the interruption cost, for the
    SliceInterrupted event: with the checkpoint-grace annotation the pod
    had a SIGTERM emergency-save window (runtime/checkpoint.py), so the
    message points at the resumable checkpoint instead of declaring the
    state gone."""
    grace = ann.parse_checkpoint_grace(
        nb.annotations.get(ann.TPU_CHECKPOINT_GRACE)
    )
    if grace is None:
        return "in-notebook PyTorch state is gone"
    ckpt_dir = (
        nb.annotations.get(ann.TPU_CHECKPOINT_DIR, "").strip()
        or ann.DEFAULT_CHECKPOINT_DIR
    )
    return (
        f"resume from the emergency checkpoint in {ckpt_dir} "
        f"(pod had {grace}s SIGTERM grace)"
    )


def _pod_to_notebook(ev) -> list[Request]:
    labels = ev.object.get("metadata", {}).get("labels", {})
    name = labels.get(ann.NOTEBOOK_NAME_LABEL)
    if name:
        return [Request(name, ev.namespace)]
    return []


def _pod_ready(pod: dict) -> bool:
    for cond in pod.get("status", {}).get("conditions", []):
        if cond.get("type") == "Ready":
            return cond.get("status") == "True"
    return False
