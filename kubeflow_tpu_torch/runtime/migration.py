"""Live slice migration: proactive save → warm-claim → restore → flip.

The port's copy of ``kubeflow_tpu/runtime/migration.py``, over the port's
tracing (``observability/tracing.py``) and its copy of the env names
(``runtime/env.py``), and driven over the port's ``CheckpointManager``.
When a preemption notice, an idle-cull decision or an operator trigger
says a slice is about to go away, :class:`MigrationOrchestrator` runs a
deadline-budgeted four-step pipeline instead of waiting for the reactive
recovery ladder:

1. **save** — one emergency save through ``CheckpointManager`` (the
   grace-budget arithmetic SIGTERM gets, started before SIGTERM arrives).
   Skip-if-fresh reads ``CheckpointManager.last_commit_age()``, the
   manager's injected monotonic clock, never the wall clock.
2. **claim** — a warm slice through an injected, fenced, deadline-bounded
   claim (``claim_fn``).
3. **restore** — rebuild the training state on the new slice with the
   exact ``start_batch`` cursor (``resume_start_batch``).
4. **flip** — route traffic to the new slice and release the old one
   drain-style; a flip never severs a stream.

**Migration is an optimization, never a new failure mode.** Every step
carries its own budget from :class:`MigrationConfig`; a step that blows
its budget, returns nothing or raises triggers ``fallback_fn`` (the
reactive ladder), records a ``MigrationFellBack`` event, and the pipeline
stops. Completion and fallback are both terminal and always reported.

Observability: ONE ``migration`` trace with a child span per step (each
budget a span attribute), Notebook events (``MigrationProgress`` per
step, ``MigrationCompleted`` / ``MigrationFellBack``), the
``migration_*_total`` counters and ``migration_seconds`` gauge read off
``metrics`` by name, :meth:`MigrationOrchestrator.stats`, and
``telemetry.observe_migration``.

Inert by default: ``migration_from_env()`` returns ``None`` unless
``KUBEFLOW_TPU_MIGRATE_ENABLE`` opts in, and parses fail-fast — a
hand-set knob never silently falls back to defaults.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

from kubeflow_tpu_torch.observability import tracing

log = logging.getLogger(__name__)

# Pipeline step names, in order. Budgets, spans, events, and the forced-
# failure tests all key off these.
MIGRATION_STEPS = ("save", "claim", "restore", "flip")


class MigrationFellBack(Exception):
    """Internal control flow: a step blew its budget / failed; the
    pipeline degrades to the reactive ladder. Never escapes
    :meth:`MigrationOrchestrator.migrate`."""

    def __init__(self, step: str, reason: str):
        super().__init__(f"{step}: {reason}")
        self.step = step
        self.reason = reason


@dataclass(frozen=True)
class MigrationConfig:
    """Per-step budgets. Frozen + validated: a bad knob fails
    construction, not a migration mid-preemption."""

    save_budget_s: float = 30.0
    claim_budget_s: float = 10.0
    restore_budget_s: float = 60.0
    flip_budget_s: float = 10.0
    # A commit younger than this (monotonic, last_commit_age) makes the
    # save step a skip: re-saving what is already durable wastes the
    # preemption notice window.
    fresh_within_s: float = 5.0

    def __post_init__(self):
        for name in ("save_budget_s", "claim_budget_s",
                     "restore_budget_s", "flip_budget_s"):
            if getattr(self, name) <= 0:
                raise ValueError(
                    f"MigrationConfig: {name} must be > 0, "
                    f"got {getattr(self, name)}"
                )
        if self.fresh_within_s < 0:
            raise ValueError(
                f"MigrationConfig: fresh_within_s must be >= 0, "
                f"got {self.fresh_within_s}"
            )

    def budget(self, step: str) -> float:
        return float(getattr(self, f"{step}_budget_s"))


@dataclass
class MigrationReport:
    """What one migrate() call did — every outcome is reported, never
    raised. ``steps`` maps step name -> {"ok", "duration_s", "detail"}
    for the steps that ran."""

    trigger: str
    completed: bool = False
    fell_back: bool = False
    failed_step: Optional[str] = None
    reason: str = ""
    pool: Optional[str] = None
    restored_step: Optional[int] = None
    start_batch: Optional[int] = None
    duration_s: float = 0.0
    steps: Optional[dict] = None


class MigrationOrchestrator:
    """Drives the four-step pipeline; every collaborator is an injected
    seam so the controller, the chaos harness, and the forced-failure
    tests wire the same object differently:

    - ``checkpoint``: a ``CheckpointManager`` (or None: nothing to save
      — the step is a recorded skip);
    - ``claim_fn(claimant, deadline)`` -> pool name or None. Production
      wraps ``claim_warm_slice(..., claimant=..., deadline=...)``;
    - ``restore_fn(deadline)`` -> ``{"step": int, "start_batch": int}``
      (extra keys kept in the report detail). Production restores the
      checkpoint into the new slice's freshly-sharded template;
    - ``flip_fn(deadline)`` -> truthy on success. Production adds the
      new replica to the gateway ring and ``begin_drain``s the old one;
    - ``fallback_fn(step, reason)``: the reactive-ladder entry point.
      Exceptions out of it are contained — the ladder hook must not be
      able to turn a fallback into a crash.

    Thread-safe: one migration at a time per orchestrator (a second
    trigger while one is in flight reports a fallback with reason
    "migration already in progress" rather than racing it).
    """

    def __init__(
        self,
        config: Optional[MigrationConfig] = None,
        *,
        checkpoint: Any = None,
        claim_fn: Optional[Callable[[str, float], Optional[str]]] = None,
        restore_fn: Optional[Callable[[float], Optional[dict]]] = None,
        flip_fn: Optional[Callable[[float], Any]] = None,
        fallback_fn: Optional[Callable[[str, str], None]] = None,
        metrics: Any = None,
        telemetry: Any = None,
        recorder: Any = None,
        notebook: Optional[dict] = None,
        clock: Optional[Callable[[], float]] = None,
    ):
        self.config = config or MigrationConfig()
        self.checkpoint = checkpoint
        self.claim_fn = claim_fn
        self.restore_fn = restore_fn
        self.flip_fn = flip_fn
        self.fallback_fn = fallback_fn
        self.metrics = metrics
        self.telemetry = telemetry
        self.recorder = recorder
        self.notebook = notebook
        self._clock = clock or time.monotonic
        self._busy = threading.Lock()
        self._stats_lock = threading.Lock()
        self._started = 0
        self._completed = 0
        self._fell_back = 0
        self._last_duration_s = 0.0
        self._last_trigger = ""
        self._last_failed_step: Optional[str] = None

    # -- the pipeline ------------------------------------------------------

    def migrate(self, trigger: str) -> MigrationReport:
        """Run the pipeline once for ``trigger`` (``"preemption-notice"``,
        ``"idle-cull"``, ``"operator"``, ...). Returns a report; never
        raises — failure IS the fallback path."""
        if not self._busy.acquire(blocking=False):
            # A concurrent trigger must not double-claim or double-flip;
            # the in-flight migration already covers this slice.
            return MigrationReport(
                trigger=trigger, fell_back=False, completed=False,
                reason="migration already in progress",
            )
        try:
            return self._migrate(trigger)
        finally:
            self._busy.release()

    def _migrate(self, trigger: str) -> MigrationReport:
        cfg = self.config
        report = MigrationReport(trigger=trigger, steps={})
        self._count("started", trigger)
        t_start = self._clock()
        with tracing.get_tracer("migration").start_span(
            "migration", trigger=trigger,
        ) as root:
            try:
                self._step_save(report)
                self._step_claim(report)
                self._step_restore(report)
                self._step_flip(report)
            except MigrationFellBack as fb:
                self._fall_back(report, fb, root)
            else:
                report.completed = True
                self._count("completed", trigger)
                root.set_attribute("completed", True)
                self._event(
                    "Normal", "MigrationCompleted",
                    f"migration ({trigger}) completed: resumed step "
                    f"{report.restored_step} (start_batch "
                    f"{report.start_batch}) on slice from pool "
                    f"{report.pool}",
                )
            report.duration_s = max(0.0, self._clock() - t_start)
            root.set_attribute("duration_s", round(report.duration_s, 6))
            with self._stats_lock:
                self._last_duration_s = report.duration_s
            if self.metrics is not None:
                gauge = getattr(self.metrics, "migration_seconds", None)
                if gauge is not None:
                    gauge.set(report.duration_s)
        return report

    def _run_step(self, report: MigrationReport, step: str,
                  body: Callable[[float, Any], str]) -> None:
        """One budgeted step: a child span, the budget as a deadline
        handed INTO the body, an elapsed check after it, and a
        MigrationProgress event on success. ``body(deadline, span)``
        returns a human detail string; raising MigrationFellBack (or
        anything else) degrades the pipeline."""
        budget = self.config.budget(step)
        t0 = self._clock()
        with tracing.get_tracer("migration").start_span(
            f"migration.{step}", budget_s=budget,
        ) as span:
            try:
                detail = body(t0 + budget, span)
            except MigrationFellBack:
                raise
            except Exception as err:  # a step crash is a fallback, not ours
                raise MigrationFellBack(step, repr(err)) from err
            elapsed = max(0.0, self._clock() - t0)
            span.set_attribute("duration_s", round(elapsed, 6))
            if elapsed > budget:
                # The step "succeeded" but ate someone else's budget: the
                # remaining steps would run against a slice that may
                # already be gone. Degrade.
                raise MigrationFellBack(
                    step, f"budget blown: {elapsed:.2f}s > {budget:g}s"
                )
            report.steps[step] = {
                "ok": True, "duration_s": round(elapsed, 6),
                "detail": detail,
            }
            self._event(
                "Normal", "MigrationProgress",
                f"migration step {step} done in {elapsed:.2f}s: {detail}",
            )

    # -- steps -------------------------------------------------------------

    def _step_save(self, report: MigrationReport) -> None:
        def body(deadline: float, span) -> str:
            ckpt = self.checkpoint
            if ckpt is None:
                span.set_attribute("skipped", "no checkpoint manager")
                return "no checkpoint manager; nothing to save"
            age = ckpt.last_commit_age()
            if age <= self.config.fresh_within_s:
                span.set_attribute("skipped", "fresh")
                return (f"last commit {age:.2f}s old "
                        f"(<= {self.config.fresh_within_s:g}s); skipped")
            committed = ckpt.emergency_save(
                grace_s=max(0.0, deadline - self._clock())
            )
            if not committed and ckpt.latest_step() is None:
                raise MigrationFellBack(
                    "save", "no checkpoint committed and none on disk"
                )
            return (f"committed step {ckpt.latest_step()}" if committed
                    else f"nothing newer than committed step "
                         f"{ckpt.latest_step()}")

        self._run_step(report, "save", body)

    def _step_claim(self, report: MigrationReport) -> None:
        def body(deadline: float, span) -> str:
            if self.claim_fn is None:
                raise MigrationFellBack("claim", "no claim path configured")
            claimant = f"migration-{report.trigger}"
            span.set_attribute("claimant", claimant)
            pool = self.claim_fn(claimant, deadline)
            if pool is None:
                raise MigrationFellBack(
                    "claim", "warm-slice claim exhausted (no matching "
                    "warm capacity within deadline)"
                )
            report.pool = pool
            span.set_attribute("pool", pool)
            return f"claimed warm slice from pool {pool} as {claimant}"

        self._run_step(report, "claim", body)

    def _step_restore(self, report: MigrationReport) -> None:
        def body(deadline: float, span) -> str:
            if self.restore_fn is None:
                raise MigrationFellBack(
                    "restore", "no restore path configured"
                )
            out = self.restore_fn(deadline)
            if not out or out.get("step") is None:
                raise MigrationFellBack(
                    "restore", "restore produced no valid step"
                )
            report.restored_step = int(out["step"])
            if out.get("start_batch") is not None:
                report.start_batch = int(out["start_batch"])
            span.set_attribute("restored_step", report.restored_step)
            if report.start_batch is not None:
                span.set_attribute("start_batch", report.start_batch)
            return (f"restored step {report.restored_step}, resuming at "
                    f"start_batch {report.start_batch}")

        self._run_step(report, "restore", body)

    def _step_flip(self, report: MigrationReport) -> None:
        def body(deadline: float, span) -> str:
            if self.flip_fn is None:
                raise MigrationFellBack("flip", "no flip path configured")
            ok = self.flip_fn(deadline)
            if not ok:
                raise MigrationFellBack(
                    "flip", "routing flip refused (endpoint conflict or "
                    "unknown replica)"
                )
            return ("routing flipped to the new slice; old slice "
                    "draining (in-flight streams keep flowing)")

        self._run_step(report, "flip", body)

    # -- fallback ----------------------------------------------------------

    def _fall_back(self, report: MigrationReport, fb: MigrationFellBack,
                   root) -> None:
        report.fell_back = True
        report.failed_step = fb.step
        report.reason = fb.reason
        report.steps[fb.step] = {"ok": False, "detail": fb.reason}
        self._count("fell_back", report.trigger, failed_step=fb.step)
        root.set_attribute("completed", False)
        root.set_attribute("failed_step", fb.step)
        root.record_error(fb)
        self._event(
            "Warning", "MigrationFellBack",
            f"migration ({report.trigger}) fell back at step {fb.step}: "
            f"{fb.reason}; reactive recovery ladder takes over",
        )
        log.warning(
            "migration (%s) fell back at %s: %s",
            report.trigger, fb.step, fb.reason,
        )
        if self.fallback_fn is not None:
            try:
                self.fallback_fn(fb.step, fb.reason)
            except Exception:
                # The ladder hook failing must not escalate a degraded
                # migration into a crash; the reactive controller is
                # level-triggered and will see the slice state anyway.
                log.exception("migration fallback hook raised")

    # -- bookkeeping -------------------------------------------------------

    def _count(self, what: str, trigger: str,
               failed_step: Optional[str] = None) -> None:
        with self._stats_lock:
            if what == "started":
                self._started += 1
                self._last_trigger = trigger
                self._last_failed_step = None
            elif what == "completed":
                self._completed += 1
            else:
                self._fell_back += 1
                self._last_failed_step = failed_step
        if self.metrics is not None:
            counter = getattr(self.metrics, {
                "started": "migration_started_total",
                "completed": "migration_completed_total",
                "fell_back": "migration_fallback_total",
            }[what], None)
            if counter is not None:
                counter.inc()
        if self.telemetry is not None:
            observe = getattr(self.telemetry, "observe_migration", None)
            if observe is not None:
                observe(what)

    def _event(self, etype: str, reason: str, message: str) -> None:
        if self.recorder is not None and self.notebook is not None:
            self.recorder.eventf(self.notebook, etype, reason, message)

    def stats(self) -> dict:
        """The /stats ``migration`` block; key literals here are the
        STATS_PARITY surface for the tpu_migration_* metric families."""
        with self._stats_lock:
            return {
                "migrations_started": self._started,
                "migrations_completed": self._completed,
                "migrations_fell_back": self._fell_back,
                "migration_last_s": round(self._last_duration_s, 6),
                "last_trigger": self._last_trigger,
                "last_failed_step": self._last_failed_step,
            }


def migration_from_env(env: Optional[dict] = None) -> Optional[MigrationConfig]:
    """None unless KUBEFLOW_TPU_MIGRATE_ENABLE opts in (migration must
    be inert by default). Raises on garbage — a hand-set env var must
    not silently fall back to defaults."""
    import os

    from kubeflow_tpu_torch.runtime.env import (
        KUBEFLOW_TPU_MIGRATE_CLAIM_BUDGET_S,
        KUBEFLOW_TPU_MIGRATE_ENABLE,
        KUBEFLOW_TPU_MIGRATE_FLIP_BUDGET_S,
        KUBEFLOW_TPU_MIGRATE_FRESH_WITHIN_S,
        KUBEFLOW_TPU_MIGRATE_RESTORE_BUDGET_S,
        KUBEFLOW_TPU_MIGRATE_SAVE_BUDGET_S,
    )

    src = os.environ if env is None else env
    raw = src.get(KUBEFLOW_TPU_MIGRATE_ENABLE, "").strip().lower()
    if raw not in ("", "0", "false", "1", "true"):
        raise ValueError(
            f"{KUBEFLOW_TPU_MIGRATE_ENABLE}={raw!r}: want 0/1/true/false"
        )
    if raw not in ("1", "true"):
        return None
    defaults = MigrationConfig()

    def _num(name: str, default: float, minimum: float) -> float:
        value = src.get(name, "").strip()
        if not value:
            return default
        try:
            got = float(value)
        except ValueError:
            got = minimum - 1
        if got < minimum:
            raise ValueError(f"{name}={value!r}: want a number >= {minimum:g}")
        return got

    return MigrationConfig(
        save_budget_s=_num(KUBEFLOW_TPU_MIGRATE_SAVE_BUDGET_S,
                           defaults.save_budget_s, 1.0),
        claim_budget_s=_num(KUBEFLOW_TPU_MIGRATE_CLAIM_BUDGET_S,
                            defaults.claim_budget_s, 1.0),
        restore_budget_s=_num(KUBEFLOW_TPU_MIGRATE_RESTORE_BUDGET_S,
                              defaults.restore_budget_s, 1.0),
        flip_budget_s=_num(KUBEFLOW_TPU_MIGRATE_FLIP_BUDGET_S,
                           defaults.flip_budget_s, 1.0),
        fresh_within_s=_num(KUBEFLOW_TPU_MIGRATE_FRESH_WITHIN_S,
                            defaults.fresh_within_s, 0.0),
    )
