"""The port's slice-health recovery against the JAX package's, on the CPU.

Each scenario of ``tests/test_preemption.py`` is one case here. It runs
on a JAX cluster and on the port's (``tests/torch_controller_env.py``:
``v5e`` 4x4 against ``h100`` 32, four hosts each, on separate
``FakeClock``s), driven step by step in lockstep. After every step every
object, every Event and the two metrics expositions are equal after
``tests/torch_gpu_swap.swap_cluster`` (its replacements of this slice:
the interruption event's "in-notebook JAX state is gone" reads
"in-notebook PyTorch state is gone" on the port's side). At the end the
JAX test's own assertions hold on both sides:

- interruption marking: the recovery clock starts at the first failure
  and keeps it through a second, progress events dedup across polls;
- transient recovery: state cleared, the duration stamped, the recovery
  annotations never on the pod template;
- escalation by a warm claim from a SlicePool (8 hosts) and by recreating
  the StatefulSet, the deadline re-armed, then capacity coming back;
- the terminal state: ``SliceRecoveryFailed``, quiet while terminal, and
  flipped to ``Recovered`` when capacity comes back late;
- a stop clears the recovery state;
- the events that name the emergency checkpoint and the termination
  grace, or that say the in-notebook state is gone.

Beside them: ``RecoveryConfig.from_env`` equals JAX's; the migration hook
is called with "preemption-notice" on a preemption and with "operator"
for the migrate-now annotation (which is consumed), as JAX's is; and a
hook that raises leaves the reactive recovery to converge on both sides
as it does without one.
"""

from __future__ import annotations

import copy
import dataclasses

import pytest

from kubeflow_tpu.api import annotations as JA
from kubeflow_tpu.controller import preemption as JPr
from kubeflow_tpu.k8s import events as JEv
from kubeflow_tpu_torch.api import annotations as PA
from kubeflow_tpu_torch.controller import preemption as PPr
from kubeflow_tpu_torch.k8s import events as PEv
from tests.test_torch_controller_loop import (  # noqa: F401 (autouse)
    _fixed_condition_clock,
)
from tests.torch_controller_env import (
    lockstep,
    make_side,
    notebook,
    slicepool,
)

CFG = dict(deadline_s=60.0, poll_initial_s=5.0, poll_max_s=20.0,
           max_escalations=2, terminal_requeue_s=600.0)
GRACE = {JA.TPU_CHECKPOINT_GRACE: "60"}
FAILED = JPr.RECOVERY_FAILED_CONDITION
assert PPr.RECOVERY_FAILED_CONDITION == FAILED


# -- side-generic helpers: tests/test_preemption.py's, for either package ------


def _ready(m, warm_pool=False, annotations=None):
    if warm_pool:
        m.c.create(slicepool(m))
        m.mgr.run_until_idle()
    m.c.create(notebook(m, annotations=annotations))
    m.mgr.run_until_idle()
    assert m.c.get("Notebook", "nb", "ns")["status"]["readyReplicas"] == 4


def _interrupt(m, pod="nb-2", kill_node=True):
    node = m.c.get("Pod", pod, "ns")["spec"]["nodeName"]
    m.node_obj = copy.deepcopy(m.c.get("Node", node))
    m.kubelet.preempt_pod(pod, "ns")
    if kill_node:
        m.c.delete("Node", node)
    m.mgr.run_until_idle()


def _restore_node(m):
    restored = copy.deepcopy(m.node_obj)
    for key in ("uid", "resourceVersion", "generation", "creationTimestamp"):
        restored["metadata"].pop(key, None)
    m.c.create(restored)


def _anns(m):
    return m.c.get("Notebook", "nb", "ns")["metadata"].get("annotations", {})


def _condition(m, cond_type):
    nb = m.c.get("Notebook", "nb", "ns")
    for c in nb.get("status", {}).get("conditions", []):
        if c["type"] == cond_type:
            return c
    return None


def _events(m, reason):
    ev = JEv if m.jax else PEv
    return [e for e in ev.events_for(m.c, "Notebook", "nb", "ns")
            if e["reason"] == reason]


def _metric(m, name):
    for line in m.metrics.expose().decode().splitlines():
        if line.startswith(name + " "):
            return float(line.split()[-1])
    return 0.0


def _ticks(m, seconds, times):
    for _ in range(times):
        m.mgr.tick(seconds)


def _run_to_terminal(m):
    for _ in range(40):
        m.mgr.tick(10)
        cond = _condition(m, FAILED)
        if cond and cond["status"] == "True":
            return
    raise AssertionError("never reached SliceRecoveryFailed")


RECOVERY_KEYS = (JA.TPU_SLICE_INTERRUPTED, JA.TPU_RECOVERY_STARTED,
                 JA.TPU_RECOVERY_ESCALATIONS, JA.TPU_RECOVERY_LAST_ESCALATION)


# -- the scenarios: each a generator of steps, then the JAX test's checks ------


def withheld_capacity(m):
    _ready(m)
    m.t0 = m.clock.now()
    _interrupt(m)
    yield "interrupted"


def check_withheld_capacity(m):
    anns = _anns(m)
    assert JA.TPU_SLICE_INTERRUPTED in anns
    assert float(anns[JA.TPU_RECOVERY_STARTED]) == m.t0
    assert JA.TPU_RECOVERY_ESCALATIONS not in anns
    assert m.mgr.next_requeue_in() is not None
    assert m.mgr.next_requeue_in() <= CFG["poll_initial_s"]


def repeat_failures(m):
    _ready(m)
    m.t0 = m.clock.now()
    _interrupt(m, pod="nb-2")
    yield "first"
    m.mgr.tick(10)
    m.kubelet.preempt_pod("nb-3", "ns")
    m.mgr.run_until_idle()
    yield "second"


def check_repeat_failures(m):
    assert float(_anns(m)[JA.TPU_RECOVERY_STARTED]) == m.t0


def progress_dedup(m):
    _ready(m)
    _interrupt(m)
    yield "interrupted"
    _ticks(m, CFG["poll_initial_s"], 5)
    yield "polled"


def check_progress_dedup(m):
    progress = _events(m, "SliceRecoveryProgress")
    assert len(progress) == 1
    assert progress[0]["count"] >= 2
    assert "3/4 hosts Ready" in progress[0]["message"]


def transient(m):
    _ready(m)
    _interrupt(m, kill_node=False)
    yield "recovered"


def check_transient(m):
    anns = _anns(m)
    assert JA.TPU_SLICE_INTERRUPTED not in anns
    assert JA.TPU_RECOVERY_STARTED not in anns
    assert anns[JA.TPU_LAST_INTERRUPTION_DURATION] == "0s"
    assert _events(m, "SliceRecovered")
    assert _metric(m, "tpu_slice_recovery_seconds_count") == 1.0
    assert _metric(m, "tpu_slice_recovery_escalations_total") == 0.0


def outage_length(m):
    _ready(m)
    _interrupt(m)
    yield "interrupted"
    _ticks(m, 10, 4)
    yield "withheld"
    _restore_node(m)
    m.mgr.tick(CFG["poll_max_s"])
    yield "recovered"


def check_outage_length(m):
    anns = _anns(m)
    assert JA.TPU_SLICE_INTERRUPTED not in anns
    stamp = float(anns[JA.TPU_LAST_INTERRUPTION_DURATION].rstrip("s"))
    assert 40 <= stamp <= 60 + CFG["poll_max_s"]
    assert "interruption" in _events(m, "SliceRecovered")[0]["message"]


def template_untouched(m):
    _ready(m)
    _interrupt(m, kill_node=False)
    yield "recovered"
    m.mgr.run_until_idle()
    yield "settled"


def check_template_untouched(m):
    assert JA.TPU_LAST_INTERRUPTION_DURATION in _anns(m)
    sts = m.c.get("StatefulSet", "nb", "ns")
    tmpl = sts["spec"]["template"]["metadata"].get("annotations", {})
    for key in RECOVERY_KEYS[:3] + (JA.TPU_LAST_INTERRUPTION_DURATION,):
        assert key not in tmpl


def warm_claim(m):
    _ready(m, warm_pool=True)
    _interrupt(m)
    yield "interrupted"
    for i in range(20):
        m.mgr.tick(10)
        yield f"tick {i}"


def check_warm_claim(m):
    anns = _anns(m)
    assert JA.TPU_SLICE_INTERRUPTED not in anns
    assert JA.TPU_RECOVERY_ESCALATIONS not in anns
    assert JA.TPU_LAST_INTERRUPTION_DURATION in anns
    escalated = _events(m, "SliceRecoveryEscalated")
    assert len(escalated) == 1
    assert "warm slice from pool pool" in escalated[0]["message"]
    assert _events(m, "ClaimedWarmSlice")
    assert _events(m, "SliceRecovered")
    assert _metric(m, "tpu_slice_recovery_escalations_total") == 1.0
    assert _metric(m, "tpu_slice_recovery_seconds_count") == 1.0


def sts_recreate(m):
    _ready(m)
    m.old_uid = m.c.get("StatefulSet", "nb", "ns")["metadata"]["uid"]
    _interrupt(m)
    yield "interrupted"
    m.mgr.tick(CFG["deadline_s"] + 1)
    yield "escalated"


def check_sts_recreate(m):
    assert _anns(m)[JA.TPU_RECOVERY_ESCALATIONS] == "1"
    escalated = _events(m, "SliceRecoveryEscalated")
    assert len(escalated) == 1
    assert "recreating StatefulSet" in escalated[0]["message"]
    sts = m.c.get("StatefulSet", "nb", "ns")
    assert sts["metadata"]["uid"] != m.old_uid
    assert _metric(m, "tpu_slice_recovery_escalations_total") == 1.0


def rearm(m):
    _ready(m)
    _interrupt(m)
    m.mgr.tick(CFG["deadline_s"] + 1)
    assert _anns(m)[JA.TPU_RECOVERY_ESCALATIONS] == "1"
    yield "escalated"
    m.mgr.tick(CFG["poll_initial_s"])
    assert _anns(m)[JA.TPU_RECOVERY_ESCALATIONS] == "1"
    yield "re-armed"
    _restore_node(m)
    _ticks(m, CFG["poll_max_s"], 4)
    yield "recovered"


def check_rearm(m):
    anns = _anns(m)
    assert JA.TPU_SLICE_INTERRUPTED not in anns
    assert JA.TPU_RECOVERY_ESCALATIONS not in anns
    assert JA.TPU_LAST_INTERRUPTION_DURATION in anns
    assert _condition(m, FAILED) is None


def terminal(m):
    _ready(m)
    _interrupt(m)
    yield "interrupted"
    _run_to_terminal(m)
    yield "terminal"


def check_terminal(m):
    cond = _condition(m, FAILED)
    assert cond["reason"] == "RecoveryDeadlineExceeded"
    assert "2 escalations" in cond["message"]
    failed = _events(m, FAILED)
    assert failed and failed[0]["type"] == "Warning"
    assert _anns(m)[JA.TPU_RECOVERY_ESCALATIONS] == "2"
    assert _metric(m, "tpu_slice_recovery_failed_total") == 1.0
    assert _metric(m, "tpu_slice_recovery_escalations_total") == 2.0


def terminal_quiet(m):
    _ready(m)
    _interrupt(m)
    _run_to_terminal(m)
    m.failed_before = len(_events(m, FAILED))
    yield "terminal"
    m.calls = m.mgr.tick(CFG["terminal_requeue_s"])
    yield "quiet"


def check_terminal_quiet(m):
    assert m.calls <= 4
    assert len(_events(m, FAILED)) == m.failed_before


def late_capacity(m):
    _ready(m)
    _interrupt(m)
    _run_to_terminal(m)
    yield "terminal"
    _restore_node(m)
    m.mgr.tick(CFG["terminal_requeue_s"])
    yield "recovered"


def check_late_capacity(m):
    anns = _anns(m)
    for key in RECOVERY_KEYS[:3]:
        assert key not in anns
    assert JA.TPU_LAST_INTERRUPTION_DURATION in anns
    cond = _condition(m, FAILED)
    assert (cond["status"], cond["reason"]) == ("False", "Recovered")
    assert _events(m, "SliceRecovered")
    assert _metric(m, "tpu_slice_recovery_seconds_count") == 1.0


def stop_clears(m):
    _ready(m)
    _interrupt(m)
    assert JA.TPU_SLICE_INTERRUPTED in _anns(m)
    yield "interrupted"
    nb = m.c.get("Notebook", "nb", "ns")
    nb["metadata"]["annotations"][JA.STOP] = "2026-01-01T00:00:00Z"
    m.c.update(nb)
    m.mgr.run_until_idle()
    yield "stopped"
    m.mgr.tick(CFG["poll_max_s"])
    yield "polled"


def check_stop_clears(m):
    anns = _anns(m)
    for key in RECOVERY_KEYS:
        assert key not in anns
    assert JA.STOP in anns


def grace_event(m):
    _ready(m, annotations=GRACE)
    _interrupt(m)
    yield "interrupted"


def check_grace_event(m):
    ev = _events(m, "SliceInterrupted")
    assert len(ev) == 1
    msg = ev[0]["message"]
    assert "resume from the emergency checkpoint in /mnt/checkpoints" in msg
    assert "60s SIGTERM grace" in msg


def no_grace_event(m):
    _ready(m)
    _interrupt(m)
    yield "interrupted"


def check_no_grace_event(m):
    framework = "JAX" if m.jax else "PyTorch"
    assert f"in-notebook {framework} state is gone" in (
        _events(m, "SliceInterrupted")[0]["message"])


def grace_recreate(m):
    _ready(m, annotations=GRACE)
    _interrupt(m)
    yield "interrupted"
    m.mgr.tick(CFG["deadline_s"] + 1)
    yield "escalated"


def check_grace_recreate(m):
    escalated = _events(m, "SliceRecoveryEscalated")
    assert len(escalated) == 1
    assert ("surviving hosts get 90s termination grace for an "
            "emergency checkpoint") in escalated[0]["message"]


def check_no_grace_recreate(m):
    escalated = _events(m, "SliceRecoveryEscalated")
    assert len(escalated) == 1
    assert "termination grace" not in escalated[0]["message"]


def raising_hook(m):
    _ready(m)
    _interrupt(m)
    yield "interrupted"
    _restore_node(m)
    _ticks(m, CFG["poll_max_s"], 3)
    yield "recovered"


def check_raising_hook(m):
    assert m.hook_calls == [("nb", "preemption-notice")]
    check_rearm(m)
    assert _events(m, "SliceRecovered")


def migrate_now(m):
    _ready(m)
    nb = m.c.get("Notebook", "nb", "ns")
    nb["metadata"]["annotations"][JA.TPU_MIGRATE_NOW] = "now"
    m.c.update(nb)
    m.mgr.run_until_idle()
    yield "consumed"
    _interrupt(m, kill_node=False)
    yield "preempted"


def check_migrate_now(m):
    assert m.hook_calls == [("nb", "operator"), ("nb", "preemption-notice")]
    assert JA.TPU_MIGRATE_NOW not in _anns(m)
    check_transient(m)


# name: (scenario, check, world keywords)
SCENARIOS = {
    "withheld-capacity-marks-state": (withheld_capacity,
                                      check_withheld_capacity, {}),
    "repeat-failures-keep-start": (repeat_failures, check_repeat_failures,
                                   {}),
    "progress-events-dedup": (progress_dedup, check_progress_dedup, {}),
    "transient-recovery": (transient, check_transient, {}),
    "duration-stamp": (outage_length, check_outage_length, {}),
    "template-untouched": (template_untouched, check_template_untouched, {}),
    "escalate-warm-claim": (warm_claim, check_warm_claim,
                            {"node_hosts": 8}),
    "escalate-sts-recreate": (sts_recreate, check_sts_recreate, {}),
    "escalation-rearms-deadline": (rearm, check_rearm, {}),
    "terminal": (terminal, check_terminal, {}),
    "terminal-is-quiet": (terminal_quiet, check_terminal_quiet, {}),
    "terminal-late-capacity": (late_capacity, check_late_capacity, {}),
    "stop-clears-state": (stop_clears, check_stop_clears, {}),
    "event-names-checkpoint": (grace_event, check_grace_event, {}),
    "event-says-state-gone": (no_grace_event, check_no_grace_event, {}),
    "recreate-event-quotes-grace": (grace_recreate, check_grace_recreate,
                                    {}),
    "recreate-event-without-grace": (sts_recreate, check_no_grace_recreate,
                                     {}),
    "hook-raises-recovery-converges": (raising_hook, check_raising_hook,
                                       {"hook": "raise"}),
    "migrate-now-annotation": (migrate_now, check_migrate_now,
                               {"hook": "record"}),
}


def _world(node_hosts=4, hook=None):
    sides = []
    for jax in (True, False):
        calls = []

        def trigger(obj, why, calls=calls):
            calls.append((obj["metadata"]["name"], why))
            if hook == "raise":
                raise RuntimeError("restore failed")

        m = make_side(jax, node_hosts=node_hosts, recovery_config=CFG,
                      migration_trigger=trigger if hook else None)
        m.hook_calls = calls
        sides.append(m)
    return sides


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_recovery_equals_jax_step_by_step(name):
    scenario, check, kw = SCENARIOS[name]
    j, p = _world(**kw)
    lockstep(j, p, scenario, check, kw.get("node_hosts", 4), what=name)


def test_recovery_config_from_env_equals_jax():
    envs = [{}, {"SLICE_RECOVERY_DEADLINE_SECONDS": "120",
                 "SLICE_RECOVERY_POLL_SECONDS": "2",
                 "SLICE_RECOVERY_POLL_MAX_SECONDS": "30",
                 "SLICE_RECOVERY_MAX_ESCALATIONS": "1",
                 "SLICE_RECOVERY_TERMINAL_REQUEUE_SECONDS": "900",
                 "SLICE_RECOVERY_CLAIM_DEADLINE_SECONDS": "3"}]
    for env in envs:
        assert dataclasses.asdict(PPr.RecoveryConfig.from_env(env)) == (
            dataclasses.asdict(JPr.RecoveryConfig.from_env(env)))
    assert PPr.RecoveryConfig.from_env(envs[1]) == PPr.RecoveryConfig(
        120.0, 2.0, 30.0, 1, 900.0, 3.0)
    assert PA.TPU_MIGRATE_NOW == JA.TPU_MIGRATE_NOW


@pytest.mark.parametrize("pod,want", [
    ({"status": {"reason": "Evicted"}}, "Evicted"),
    ({"status": {"conditions": [{"type": "DisruptionTarget",
                                 "status": "True"}]}}, "DisruptionTarget"),
    ({"status": {"phase": "Failed"}}, "PodFailed"),
    ({"status": {"phase": "Running"}}, None),
])
def test_preempted_pod_reasons_equal_jax(pod, want):
    assert PPr._pod_preempted(pod) == JPr._pod_preempted(pod) == want
