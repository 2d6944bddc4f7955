"""The port's live-migration orchestrator against the JAX package's.

Every case of ``tests/test_migration.py`` runs on both packages'
``MigrationOrchestrator`` with the same fakes (clock, checkpoint, claim,
restore and flip), the JAX package's ``Metrics``, ``EventRecorder`` and
``FleetTelemetry``, and each package's own tracing exporter: the reports,
the fallbacks, the events, the counter text, ``stats()`` and the spans
must be equal, and the port's must hold what the reference asserts. Then
the ``migration-storm`` chaos scenario over the port's tiny trainer and
``CheckpointManager``: two migrations and a final segment, every loss
equal, batch index by batch index, to the uninterrupted run's.
"""

from __future__ import annotations

import dataclasses
import shutil
import threading

import pytest
import torch

from kubeflow_tpu.k8s.events import EventRecorder
from kubeflow_tpu.k8s.fake import FakeCluster
from kubeflow_tpu.metrics import Metrics
from kubeflow_tpu.observability import tracing as JT
from kubeflow_tpu.observability.signals import FleetTelemetry, SignalsConfig
from kubeflow_tpu.runtime import migration as JM
from kubeflow_tpu_torch.models.train import make_tiny_trainer
from kubeflow_tpu_torch.observability import tracing as PT
from kubeflow_tpu_torch.runtime import checkpoint as P
from kubeflow_tpu_torch.runtime import migration as PM

SIDES = {"jax": (JM, JT), "port": (PM, PT)}


class _FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class _FakeCheckpoint:
    """Just enough CheckpointManager surface for the save step."""

    def __init__(self, age=float("inf"), latest=None, commit_ok=True):
        self.age = age
        self.latest = latest
        self.commit_ok = commit_ok
        self.emergency_calls = []

    def last_commit_age(self):
        return self.age

    def latest_step(self):
        return self.latest

    def emergency_save(self, grace_s):
        self.emergency_calls.append(grace_s)
        if self.commit_ok:
            self.latest = (self.latest or 0) + 1
            return True
        return False


def _orchestrator(mod, clock=None, **kw):
    clock = clock or _FakeClock()
    kw.setdefault("checkpoint", _FakeCheckpoint(latest=3))
    kw.setdefault("claim_fn", lambda claimant, deadline: "pool-a")
    kw.setdefault("restore_fn", lambda deadline: {"step": 3, "start_batch": 4})
    kw.setdefault("flip_fn", lambda deadline: True)
    fallbacks = []
    kw.setdefault("fallback_fn",
                  lambda step, reason: fallbacks.append((step, reason)))
    orch = mod.MigrationOrchestrator(kw.pop("config", mod.MigrationConfig()),
                                     clock=clock, **kw)
    orch._test_fallbacks = fallbacks
    return orch


def _span_tree(exporter) -> list:
    index = {s.span_id: s.name for s in exporter.spans}
    return [(s.name, index.get(s.parent_id), dict(s.attributes),
             [e["name"] if isinstance(e, dict) else e[0]
              for e in getattr(s, "events", [])])
            for s in exporter.spans]


def _metric_lines(metrics) -> list:
    """The tpu_migration_* samples, without the ``_created`` timestamps."""
    return sorted(line for line in metrics.expose().decode().splitlines()
                  if line.startswith("tpu_migration_")
                  and "_created" not in line)


def _run(make, migrate):
    """``make(mod)`` -> (orchestrator, extras) per package; ``migrate``
    drives it and returns what to compare. Each package traces into its
    own exporter."""
    got = {}
    for name, (mod, tracing) in SIDES.items():
        exporter = tracing.InMemoryExporter()
        tracing.set_tracer_provider(tracing.TracerProvider(exporter=exporter))
        try:
            orch, extras = make(mod)
            out = migrate(orch, extras)
        finally:
            tracing.set_tracer_provider(tracing.TracerProvider())
        got[name] = {"out": out, "stats": orch.stats(),
                     "fallbacks": orch._test_fallbacks,
                     "spans": _span_tree(exporter)}
    assert got["port"] == got["jax"]
    return got["port"]


def _report(report) -> dict:
    return dataclasses.asdict(report)


def _plain(trigger="preemption-notice", **kw):
    def make(mod):
        return _orchestrator(mod, **{k: v() for k, v in kw.items()}), None
    return make, lambda orch, _: _report(orch.migrate(trigger))


class TestPipeline:
    def test_happy_path_completes_with_full_trace(self):
        got = _run(*_plain())
        report = got["out"]
        assert report["completed"] and not report["fell_back"]
        assert report["pool"] == "pool-a"
        assert (report["restored_step"], report["start_batch"]) == (3, 4)
        assert set(report["steps"]) == set(PM.MIGRATION_STEPS)
        assert all(s["ok"] for s in report["steps"].values())
        roots = [s for s in got["spans"] if s[0] == "migration"]
        assert len(roots) == 1 and roots[0][2]["completed"] is True
        for step in PM.MIGRATION_STEPS:
            spans = [s for s in got["spans"] if s[0] == f"migration.{step}"]
            assert len(spans) == 1 and spans[0][1] == "migration"
            assert spans[0][2]["budget_s"] > 0

    def test_save_skipped_when_commit_is_fresh(self):
        def make(mod):
            ckpt = _FakeCheckpoint(age=1.0, latest=7)
            return _orchestrator(mod, checkpoint=ckpt), ckpt

        got = _run(make, lambda orch, ckpt: (
            _report(orch.migrate("operator")), ckpt.emergency_calls))
        report, calls = got["out"]
        assert report["completed"] and calls == []
        assert "skipped" in report["steps"]["save"]["detail"]

    def test_stale_commit_forces_emergency_save(self):
        def make(mod):
            ckpt = _FakeCheckpoint(age=120.0, latest=7)
            return _orchestrator(mod, checkpoint=ckpt), ckpt

        got = _run(make, lambda orch, ckpt: (
            _report(orch.migrate("operator")), ckpt.emergency_calls))
        report, calls = got["out"]
        assert report["completed"] and len(calls) == 1
        assert 0 < calls[0] <= PM.MigrationConfig().save_budget_s

    def test_concurrent_trigger_does_not_double_claim(self):
        def make(mod):
            claims, release = [], threading.Event()

            def slow_claim(claimant, deadline):
                claims.append(claimant)
                release.wait(timeout=5.0)
                return "pool-a"

            return _orchestrator(mod, claim_fn=slow_claim), (claims, release)

        def migrate(orch, extras):
            claims, release = extras
            t = threading.Thread(target=orch.migrate,
                                 args=("preemption-notice",), daemon=True)
            t.start()
            while not claims:
                pass
            second = orch.migrate("operator")
            release.set()
            t.join(timeout=5.0)
            return [t.is_alive(), _report(second), list(claims)]

        alive, second, claims = _run(make, migrate)["out"]
        assert not alive and len(claims) == 1
        assert second["reason"] == "migration already in progress"
        assert not second["completed"] and not second["fell_back"]


def _fell_back(got, step):
    report = got["out"] if isinstance(got["out"], dict) else got["out"][0]
    assert report["fell_back"] and not report["completed"]
    assert report["failed_step"] == step
    assert got["fallbacks"] and got["fallbacks"][0][0] == step
    stats = got["stats"]
    assert (stats["migrations_started"], stats["migrations_fell_back"],
            stats["migrations_completed"]) == (1, 1, 0)
    assert stats["last_failed_step"] == step
    return report


class TestForcedStepFailures:
    def test_save_timeout_falls_back(self):
        def make(mod):
            clock = _FakeClock()
            ckpt = _FakeCheckpoint(age=120.0, latest=None, commit_ok=False)

            def slow_save(grace_s):
                clock.advance(mod.MigrationConfig().save_budget_s + 1.0)
                return False

            ckpt.emergency_save = slow_save
            return _orchestrator(mod, clock=clock, checkpoint=ckpt), None

        got = _run(make, lambda orch, _: _report(
            orch.migrate("preemption-notice")))
        _fell_back(got, "save")
        root = [s for s in got["spans"] if s[0] == "migration"][0]
        assert root[2]["failed_step"] == "save"
        assert not [s for s in got["spans"] if s[0] == "migration.claim"]

    def test_save_with_nothing_durable_falls_back(self):
        got = _run(*_plain(checkpoint=lambda: _FakeCheckpoint(
            age=float("inf"), latest=None, commit_ok=False)))
        assert "none on disk" in _fell_back(got, "save")["reason"]

    def test_claim_exhaustion_falls_back(self):
        got = _run(*_plain(claim_fn=lambda: lambda claimant, deadline: None))
        assert "exhausted" in _fell_back(got, "claim")["reason"]

    def test_restore_corruption_falls_back(self):
        def corrupt_restore(deadline):
            raise RuntimeError("checksum mismatch: quarantined corrupt-3")

        got = _run(*_plain(restore_fn=lambda: corrupt_restore))
        assert "checksum mismatch" in _fell_back(got, "restore")["reason"]

    def test_flip_conflict_falls_back(self):
        got = _run(*_plain(flip_fn=lambda: lambda deadline: False))
        reason = _fell_back(got, "flip")["reason"]
        assert "conflict" in reason or "refused" in reason

    def test_budget_blowout_mid_step_falls_back(self):
        def make(mod):
            clock = _FakeClock()

            def slow_restore(deadline):
                clock.advance(mod.MigrationConfig().restore_budget_s + 5.0)
                return {"step": 3, "start_batch": 4}

            return _orchestrator(mod, clock=clock,
                                 restore_fn=slow_restore), None

        got = _run(make, lambda orch, _: _report(
            orch.migrate("preemption-notice")))
        assert "budget blown" in _fell_back(got, "restore")["reason"]
        assert not [s for s in got["spans"] if s[0] == "migration.flip"]

    def test_fallback_hook_crash_is_contained(self):
        def bad_hook(step, reason):
            raise RuntimeError("ladder hook exploded")

        got = _run(*_plain(claim_fn=lambda: lambda c, d: None,
                           fallback_fn=lambda: bad_hook))
        assert got["out"]["fell_back"]
        assert got["out"]["failed_step"] == "claim"


_NB = {"apiVersion": "kubeflow.org/v1", "kind": "Notebook",
       "metadata": {"name": "nb", "namespace": "ns"}}


def _events(client) -> list:
    return [(e["type"], e["reason"], e["message"])
            for e in client.list("Event", "ns")]


class TestObservability:
    def test_events_and_metrics_and_signals(self):
        def make(mod):
            client = FakeCluster()
            metrics = Metrics(client)
            telemetry = FleetTelemetry(SignalsConfig(window_s=60.0,
                                                     windows=10))
            orch = _orchestrator(
                mod, metrics=metrics, telemetry=telemetry,
                recorder=EventRecorder(client, component="migration"),
                notebook=_NB)
            return orch, (client, metrics, telemetry)

        def migrate(orch, extras):
            client, metrics, telemetry = extras
            report = _report(orch.migrate("preemption-notice"))
            fleet = telemetry.snapshot()["fleet"]
            return [report, sorted(_events(client)), _metric_lines(metrics),
                    [fleet["migration_started_per_s"] > 0,
                     fleet["migration_completed_per_s"] > 0,
                     fleet["migration_fell_back_per_s"]]]

        report, events, lines, rates = _run(make, migrate)["out"]
        assert report["completed"]
        reasons = {reason for _, reason, _ in events}
        assert {"MigrationProgress", "MigrationCompleted"} <= reasons
        assert "tpu_migration_started_total 1.0" in lines
        assert "tpu_migration_completed_total 1.0" in lines
        assert "tpu_migration_fallback_total 0.0" in lines
        assert rates == [True, True, 0]

    def test_fallback_emits_warning_event_and_counter(self):
        def make(mod):
            client = FakeCluster()
            metrics = Metrics(client)
            orch = _orchestrator(
                mod, metrics=metrics, notebook=_NB,
                recorder=EventRecorder(client, component="migration"),
                claim_fn=lambda c, d: None)
            return orch, (client, metrics)

        def migrate(orch, extras):
            client, metrics = extras
            orch.migrate("idle-cull")
            return [sorted(_events(client)), _metric_lines(metrics)]

        events, lines = _run(make, migrate)["out"]
        fell = [e for e in events if e[1] == "MigrationFellBack"]
        assert fell and fell[0][0] == "Warning"
        assert "reactive recovery ladder takes over" in fell[0][2]
        assert "tpu_migration_fallback_total 1.0" in lines

    def test_stats_block_keys(self):
        got = _run(*_plain(trigger="operator"))
        for key in ("migrations_started", "migrations_completed",
                    "migrations_fell_back", "migration_last_s"):
            assert key in got["stats"]


class TestConfig:
    def test_validation_rejects_nonpositive_budgets(self):
        for kw in (dict(claim_budget_s=0), dict(fresh_within_s=-1),
                   dict(save_budget_s=-2), dict(flip_budget_s=0.0)):
            with pytest.raises(ValueError) as jax_err:
                JM.MigrationConfig(**kw)
            with pytest.raises(ValueError) as port_err:
                PM.MigrationConfig(**kw)
            assert str(port_err.value) == str(jax_err.value)

    @pytest.mark.parametrize("env", [
        {}, {"KUBEFLOW_TPU_MIGRATE_ENABLE": "0"},
        {"KUBEFLOW_TPU_MIGRATE_ENABLE": "false"},
        {"KUBEFLOW_TPU_MIGRATE_ENABLE": "true",
         "KUBEFLOW_TPU_MIGRATE_SAVE_BUDGET_S": "12",
         "KUBEFLOW_TPU_MIGRATE_FRESH_WITHIN_S": "0"},
        {"KUBEFLOW_TPU_MIGRATE_ENABLE": " 1 ",
         "KUBEFLOW_TPU_MIGRATE_CLAIM_BUDGET_S": "3.5",
         "KUBEFLOW_TPU_MIGRATE_RESTORE_BUDGET_S": "300",
         "KUBEFLOW_TPU_MIGRATE_FLIP_BUDGET_S": "1"},
    ], ids=repr)
    def test_env_parses_as_jax_does(self, env):
        want = JM.migration_from_env(env)
        got = PM.migration_from_env(env)
        assert (got is None) == (want is None)
        if want is not None:
            assert dataclasses.asdict(got) == dataclasses.asdict(want)

    def test_env_opt_in_with_overrides(self):
        cfg = PM.migration_from_env({
            "KUBEFLOW_TPU_MIGRATE_ENABLE": "true",
            "KUBEFLOW_TPU_MIGRATE_SAVE_BUDGET_S": "12",
            "KUBEFLOW_TPU_MIGRATE_FRESH_WITHIN_S": "0",
        })
        assert (cfg.save_budget_s, cfg.fresh_within_s) == (12.0, 0.0)
        assert cfg.claim_budget_s == PM.MigrationConfig().claim_budget_s

    @pytest.mark.parametrize("env", [
        {"KUBEFLOW_TPU_MIGRATE_ENABLE": "yes"},
        {"KUBEFLOW_TPU_MIGRATE_ENABLE": "1",
         "KUBEFLOW_TPU_MIGRATE_CLAIM_BUDGET_S": "banana"},
        {"KUBEFLOW_TPU_MIGRATE_ENABLE": "1",
         "KUBEFLOW_TPU_MIGRATE_FLIP_BUDGET_S": "0.1"},
        {"KUBEFLOW_TPU_MIGRATE_ENABLE": "1",
         "KUBEFLOW_TPU_MIGRATE_FRESH_WITHIN_S": "-1"},
    ], ids=repr)
    def test_env_fail_fast_on_garbage(self, env):
        with pytest.raises(ValueError) as jax_err:
            JM.migration_from_env(env)
        with pytest.raises(ValueError) as port_err:
            PM.migration_from_env(env)
        assert str(port_err.value) == str(jax_err.value)

    def test_env_reads_os_environ(self, monkeypatch):
        monkeypatch.setenv("KUBEFLOW_TPU_MIGRATE_ENABLE", "1")
        monkeypatch.setenv("KUBEFLOW_TPU_MIGRATE_FLIP_BUDGET_S", "7")
        assert PM.migration_from_env().flip_budget_s == 7.0


# -- the migration-storm chaos scenario on the port --------------------------


def test_migration_storm_resumes_loss_exact(tmp_path):
    """kubeflow_tpu/k8s/chaos_catalog.py's migration storm over the port's
    tiny trainer: 2 migrations, one step between them, then a final
    segment; each restore is a fresh manager into a different init (key
    7), so equal losses can come only from the checkpoint's bytes."""
    torch.set_num_threads(1)
    migrations, steps_between = 2, 1
    step_fn, fresh_state, batches = make_tiny_trainer(steps=6, device="cpu")
    ref_state = fresh_state(0)
    ref_losses = []
    for batch in batches:
        ref_state, loss = step_fn(ref_state, batch)
        ref_losses.append(float(loss))
    assert len(set(ref_losses)) == len(batches)

    workdir = tmp_path / "storm"
    exporter = PT.InMemoryExporter()
    PT.set_tracer_provider(PT.TracerProvider(exporter=exporter))
    try:
        live = {"mgr": P.CheckpointManager(workdir, max_to_keep=10),
                "state": fresh_state(0), "cursor": 0}
        trained = []

        def train(n_steps: int) -> int:
            done = 0
            while done < n_steps and live["cursor"] < len(batches):
                i = live["cursor"]
                live["state"], loss = step_fn(live["state"], batches[i])
                live["cursor"] = i + 1
                live["mgr"].save(live["cursor"], live["state"],
                                 metadata={"start_batch": live["cursor"]})
                trained.append((i, float(loss)))
                done += 1
            return done

        class _LiveCheckpoint:
            @staticmethod
            def last_commit_age():
                return live["mgr"].last_commit_age()

            @staticmethod
            def latest_step():
                return live["mgr"].latest_step()

            @staticmethod
            def emergency_save(grace_s=None):
                return live["mgr"].emergency_save(grace_s=grace_s)

        warm = [f"warm-{i}" for i in range(migrations)]
        claimed, routing = [], {"active": "slice-0", "drained": []}

        def claim_fn(claimant, deadline):
            if not warm:
                return None
            pool = warm.pop(0)
            claimed.append((claimant, pool))
            return pool

        def restore_fn(deadline):
            mgr2 = P.CheckpointManager(workdir, max_to_keep=10)
            restored, at = mgr2.restore_latest(fresh_state(7))
            if at is None:
                return None
            live["mgr"], live["state"] = mgr2, restored
            live["cursor"] = P.resume_start_batch(mgr2, at)
            return {"step": at, "start_batch": live["cursor"]}

        def flip_fn(deadline):
            if not claimed:
                return False
            routing["drained"].append(routing["active"])
            routing["active"] = claimed[-1][1]
            return True

        fallbacks = []
        orch = PM.MigrationOrchestrator(
            PM.MigrationConfig(fresh_within_s=0.0),
            checkpoint=_LiveCheckpoint(), claim_fn=claim_fn,
            restore_fn=restore_fn, flip_fn=flip_fn,
            fallback_fn=lambda step, reason: fallbacks.append((step, reason)))
        reports, segments = [], []
        for _ in range(migrations):
            segments.append(train(steps_between))
            reports.append(orch.migrate("preemption-notice"))
        segments.append(train(len(batches) - live["cursor"]))

        roots = exporter.by_name("migration")
        want_children = sorted(f"migration.{s}" for s in PM.MIGRATION_STEPS)
        complete = sum(
            root.attributes.get("completed") is True
            and sorted(s.name for s in exporter.spans
                       if s.parent_id == root.span_id) == want_children
            for root in roots)
    finally:
        PT.set_tracer_provider(PT.TracerProvider())
        shutil.rmtree(workdir, ignore_errors=True)

    assert [r.completed for r in reports] == [True] * migrations
    assert not fallbacks
    assert [r.restored_step for r in reports] == [1, 2]
    assert [r.steps["save"]["detail"] for r in reports] == [
        "nothing newer than committed step 1",
        "nothing newer than committed step 2"]
    assert [i for i, _ in trained] == list(range(len(batches)))
    assert [loss for _, loss in trained] == ref_losses
    assert segments == [1, 1, len(batches) - 2]
    assert complete == len(roots) == migrations
    assert routing == {"active": "warm-1", "drained": ["slice-0", "warm-0"]}
    stats = orch.stats()
    assert (stats["migrations_completed"], stats["migrations_fell_back"]) == (
        migrations, 0)
