"""Trace-driven fleet autoscaler: closes the loop from signals to replicas.

The port's own copy of the JAX package's ``models/autoscaler.py``, with
the same names, decisions and reasons. A :class:`FleetAutoscaler` rides
the gateway's probe loop and, once a pass, turns the telemetry snapshot
and the SLO burn report into at most one capacity action a tier:

- **scale-up**: claim a replica through the provisioner;
- **scale-down**: drain the least-loaded replica (out of the ring first,
  its in-flight streams keep flowing), wait out a bounded drain budget,
  and only then release it.

``tier_mode="disagg"`` scales the prefill and decode tiers independently:
prefill on TTFT burn in both fast windows or a member's queue-wait p95
over its SLO; decode on inter-token burn or mean ragged batch fill over
``high_batch_fill``. A fused fleet is one tier fed by every signal.

Invariants:

- **hysteresis**: pressure must persist ``up_consecutive`` /
  ``down_consecutive`` ticks, and each direction has its own cooldown;
- **rate limit**: at most ``max_actions_per_window`` actions a
  ``actions_window_s``, fleet-wide;
- **never kill a stream**: scale-down drains before it releases, and the
  capacity left must clear ``headroom`` x the current in-flight;
- **never flap on claim failures**: a failed claim backs off
  exponentially with jitter and holds capacity;
- **freeze on garbage**: missing telemetry, an empty ring, or an in-ring
  replica whose scrape is older than ``stale_after_s`` freezes scaling;
- **explainable**: each decision is a traced span and a ring-buffer
  entry with its reasons, served at ``/debug/autoscaler``.

The provisioner is duck-typed (:class:`WarmSliceProvisioner` documents
the contract), so a test or ``chip_smoke.py`` substitutes its own fleet. The
default one scales up through ``ServingGateway.scale_up``, which claims
through the gateway's replica source: ``models/gateway.py``'s
``WarmSliceReplicaSource`` over ``controller/slicepool.py``.

Inert by default: the gateway builds one only when
``KUBEFLOW_TPU_AUTOSCALE_ENABLE`` opts in or a config is passed.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import random
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

from kubeflow_tpu_torch.observability import tracing

# Which fleet SLO objectives feed each tier's burn-based pressure. The
# queue-wait objective is fleet-wide (any replica trips it), so disagg
# tiers use the per-member queue-wait gauge instead — a decode replica's
# queue must not grow the prefill tier.
TIER_OBJECTIVES = {
    "prefill": ("ttft_p95",),
    "decode": ("inter_token_p95",),
    "fused": ("ttft_p95", "inter_token_p95", "queue_wait_p95"),
}


# The port's own copies of the env contract names this module reads
# (the JAX package's webhook/tpu_env.py), under the same names.
KUBEFLOW_TPU_AUTOSCALE_DOWN_COOLDOWN_S = (
    "KUBEFLOW_TPU_AUTOSCALE_DOWN_COOLDOWN_S"
)
KUBEFLOW_TPU_AUTOSCALE_DRAIN_BUDGET_S = "KUBEFLOW_TPU_AUTOSCALE_DRAIN_BUDGET_S"
KUBEFLOW_TPU_AUTOSCALE_ENABLE = "KUBEFLOW_TPU_AUTOSCALE_ENABLE"
KUBEFLOW_TPU_AUTOSCALE_MAX_ACTIONS = "KUBEFLOW_TPU_AUTOSCALE_MAX_ACTIONS"
KUBEFLOW_TPU_AUTOSCALE_MAX_REPLICAS = "KUBEFLOW_TPU_AUTOSCALE_MAX_REPLICAS"
KUBEFLOW_TPU_AUTOSCALE_MIN_REPLICAS = "KUBEFLOW_TPU_AUTOSCALE_MIN_REPLICAS"
KUBEFLOW_TPU_AUTOSCALE_STALE_AFTER_S = "KUBEFLOW_TPU_AUTOSCALE_STALE_AFTER_S"
KUBEFLOW_TPU_AUTOSCALE_UP_COOLDOWN_S = "KUBEFLOW_TPU_AUTOSCALE_UP_COOLDOWN_S"
KUBEFLOW_TPU_AUTOSCALE_WINDOW_S = "KUBEFLOW_TPU_AUTOSCALE_WINDOW_S"


@dataclass(frozen=True)
class AutoscalerConfig:
    """Control-loop shape. Frozen + validated: a bad knob must fail the
    gateway's construction, not surface as runtime flapping."""

    min_replicas: int = 1
    max_replicas: int = 4
    # Pressure thresholds: burn >= up_burn in BOTH fast SLO windows is
    # up-pressure; every burn <= down_burn (plus an idle queue) is ebb.
    up_burn: float = 1.0
    down_burn: float = 0.25
    high_batch_fill: float = 0.85
    low_batch_fill: float = 0.30
    # Hysteresis: consecutive ticks of sustained pressure before acting.
    up_consecutive: int = 2
    down_consecutive: int = 3
    up_cooldown_s: float = 30.0
    down_cooldown_s: float = 60.0
    # Fleet-wide action rate limit.
    max_actions_per_window: int = 4
    actions_window_s: float = 300.0
    # Scale-down drains this long before force-releasing the slice.
    drain_budget_s: float = 60.0
    # Any in-ring replica scraped longer ago than this freezes scaling.
    stale_after_s: float = 10.0
    # Claim-failure backoff (exponential, jittered, degrade-to-hold).
    claim_backoff_base_s: float = 1.0
    claim_backoff_max_s: float = 60.0
    claim_backoff_jitter: float = 0.25
    # Scale-down headroom guard: capacity after removal must cover
    # in-flight × headroom, so a drain can never force a shed.
    headroom: float = 1.2
    decision_ring: int = 256

    def __post_init__(self):
        def _bad(msg):
            raise ValueError(f"AutoscalerConfig: {msg}")

        if not (0 <= self.min_replicas <= self.max_replicas):
            _bad(f"want 0 <= min_replicas <= max_replicas, got "
                 f"{self.min_replicas}/{self.max_replicas}")
        if self.max_replicas < 1:
            _bad(f"max_replicas must be >= 1, got {self.max_replicas}")
        if not (0.0 <= self.down_burn < self.up_burn):
            _bad(f"want 0 <= down_burn < up_burn, got "
                 f"{self.down_burn}/{self.up_burn}")
        if not (0.0 < self.low_batch_fill < self.high_batch_fill <= 1.0):
            _bad(f"want 0 < low_batch_fill < high_batch_fill <= 1, got "
                 f"{self.low_batch_fill}/{self.high_batch_fill}")
        if self.up_consecutive < 1 or self.down_consecutive < 1:
            _bad("up/down_consecutive must be >= 1")
        if self.up_cooldown_s < 0 or self.down_cooldown_s < 0:
            _bad("cooldowns must be >= 0")
        if self.max_actions_per_window < 1:
            _bad(f"max_actions_per_window must be >= 1, got "
                 f"{self.max_actions_per_window}")
        for name in ("actions_window_s", "drain_budget_s", "stale_after_s",
                     "claim_backoff_base_s", "claim_backoff_max_s"):
            if getattr(self, name) <= 0:
                _bad(f"{name} must be > 0, got {getattr(self, name)}")
        if self.claim_backoff_jitter < 0:
            _bad("claim_backoff_jitter must be >= 0")
        if self.headroom < 1.0:
            _bad(f"headroom must be >= 1.0, got {self.headroom}")
        if self.decision_ring < 1:
            _bad("decision_ring must be >= 1")


@dataclass
class _TierState:
    up_streak: int = 0
    down_streak: int = 0
    up_cooldown_until: float = 0.0
    down_cooldown_until: float = 0.0
    claim_failures: int = 0
    claim_backoff_until: float = 0.0
    # Dedupe key so a suppressed action logs one hold per episode, not
    # one per probe tick.
    last_hold_key: str = ""


class WarmSliceProvisioner:
    """Production provisioner: capacity is warm slices.

    The provisioner contract the autoscaler drives (duck-typed, so
    tests and ``chip_smoke.py`` substitute in-process fleets):

    - ``scale_up(tier, now=None)`` → claim handle (pool name /
      endpoint) or ``None`` on failure;
    - ``drain(endpoint)`` → begin the replica's graceful drain;
    - ``drained(endpoint)`` → True once its in-flight work finished;
    - ``release(endpoint)`` → give the capacity back.

    Here scale-up claims through the gateway's ``replica_source`` (the
    claimed replica's InferenceServer registers itself via
    ``add_replica`` once healthy; with no source it returns None). Drain/release
    are delegated callables because slice teardown is a deployment
    concern — typically "delete the replica's pod with a termination
    grace period >= the drain budget", letting SIGTERM start the
    server's own graceful drain. Without a ``drained_fn`` the replica's
    /stats is polled directly: idle means no active slots and an empty
    queue (an unreachable replica counts as drained — it is gone).
    """

    def __init__(self, gateway, *,
                 drain_fn: Optional[Callable[[str], None]] = None,
                 drained_fn: Optional[Callable[[str], bool]] = None,
                 release_fn: Optional[Callable[[str], None]] = None,
                 probe_timeout_s: float = 2.0):
        self.gateway = gateway
        self._drain_fn = drain_fn
        self._drained_fn = drained_fn
        self._release_fn = release_fn
        self.probe_timeout_s = probe_timeout_s

    def scale_up(self, tier: str, now: Optional[float] = None):
        return self.gateway.scale_up(now=now)

    def drain(self, endpoint: str) -> None:
        if self._drain_fn is not None:
            self._drain_fn(endpoint)
        # Without a drain hook the gateway-side ring removal is still
        # what stops new streams; the replica keeps its in-flight work.

    def drained(self, endpoint: str) -> bool:
        if self._drained_fn is not None:
            return bool(self._drained_fn(endpoint))
        host, _, port = endpoint.rpartition(":")
        try:
            conn = http.client.HTTPConnection(
                host, int(port), timeout=self.probe_timeout_s
            )
            try:
                conn.request("GET", "/stats")
                stats = json.loads(conn.getresponse().read())
            finally:
                conn.close()
        except (OSError, ValueError):
            return True  # unreachable: its streams are already gone
        return not (stats.get("active_slots") or stats.get("queued"))

    def release(self, endpoint: str) -> None:
        if self._release_fn is not None:
            self._release_fn(endpoint)


class FleetAutoscaler:
    """The control loop. ``tick()`` rides the gateway's probe cadence;
    everything it reads comes from ``gateway.stats()`` (fleet
    membership, per-replica load), ``telemetry.snapshot()`` (gauges,
    scrape ages) and ``telemetry.evaluate_slo()`` (burn rates)."""

    def __init__(self, gateway, config: Optional[AutoscalerConfig] = None,
                 *, provisioner=None,
                 clock: Optional[Callable[[], float]] = None,
                 rng: Optional[Callable[[], float]] = None,
                 metrics=None):
        self.gateway = gateway
        self.config = config or AutoscalerConfig()
        self.provisioner = (
            provisioner if provisioner is not None
            else WarmSliceProvisioner(gateway)
        )
        self._clock = clock
        self.rng = rng or random.random
        self.metrics = metrics
        # Two locks with distinct jobs (a tick that held one lock across
        # provisioner HTTP and a slow claim would starve stats()/debug
        # readers for seconds):
        #  - _tick_lock single-flights the control loop; taken with
        #    blocking=False so an overlapping cadence tick returns
        #    immediately instead of queueing behind a slow claim;
        #  - _lock guards the reader-visible state (counters, decision
        #    ring, _draining, tier sizes) and is only ever held for
        #    brief mutations/reads — never across a provisioner or
        #    gateway call. RLock: debug() re-enters via stats().
        self._tick_lock = threading.Lock()
        self._lock = threading.RLock()
        self._tier_state: dict = {}
        self._tier_sizes: dict = {}
        # endpoint -> {"tier", "since", "deadline"} while draining.
        self._draining: dict = {}
        self._action_times: deque = deque()
        self._decisions: deque = deque(maxlen=self.config.decision_ring)
        self._frozen = False
        self._scale_ups = 0
        self._scale_downs = 0
        self._holds = 0
        self._freezes = 0
        self._claim_attempts = 0
        self._claim_failures = 0
        self._claim_latency_last = 0.0

    # -- clock -------------------------------------------------------------

    def _now(self) -> float:
        if self._clock is not None:
            return self._clock()
        tel = self.gateway.telemetry
        return tel.clock() if tel is not None else time.monotonic()

    # -- the loop ----------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> list:
        """One control pass; returns the decisions it recorded (empty
        on a quiet tick, or when another tick is still in flight — the
        loop is single-flighted so a slow claim walk never queues
        ticks). At most one scale action per tier per tick. The state
        lock is never held across provisioner/gateway I/O, so stats()
        and /debug/autoscaler stay responsive mid-tick."""
        if not self._tick_lock.acquire(blocking=False):
            return []
        try:
            now = self._now() if now is None else now
            done: list = []
            self._advance_drains(now, done)
            freeze = self._staleness_reason(now)
            if freeze is not None:
                self._freeze(now, freeze, done)
                return done
            with self._lock:
                self._frozen = False
            tel = self.gateway.telemetry
            gwstats = self.gateway.stats()
            slo = tel.evaluate_slo(now=now)
            snap = tel.snapshot(now=now)
            for tier in self._tiers():
                self._evaluate_tier(tier, gwstats, slo, snap, now, done)
            return done
        finally:
            self._tick_lock.release()

    def _tiers(self):
        if getattr(self.gateway, "tier_mode", "fused") == "disagg":
            return ("prefill", "decode")
        return ("fused",)

    # -- staleness freeze --------------------------------------------------

    def _staleness_reason(self, now: float) -> Optional[str]:
        tel = self.gateway.telemetry
        if tel is None:
            return "telemetry disabled: no signals to act on"
        eps = sorted(self.gateway.ring_nodes())
        if not eps:
            return "no in-ring replicas to read signals from"
        ages = tel.scrape_ages(now=now)
        missing = [ep for ep in eps if ep not in ages]
        if missing:
            return f"no scrape yet from {', '.join(missing[:3])}"
        worst_ep = max(eps, key=lambda e: ages[e])
        worst = ages[worst_ep]
        if worst > self.config.stale_after_s:
            return (f"stale telemetry: {worst_ep} last scraped "
                    f"{worst:.1f}s ago (> {self.config.stale_after_s:g}s)")
        return None

    def _freeze(self, now: float, reason: str, done: list) -> None:
        with self._lock:
            if self._frozen:
                return  # one freeze decision per episode, not per tick
            self._frozen = True
            self._freezes += 1
            for st in self._tier_state.values():
                st.up_streak = st.down_streak = 0
                st.last_hold_key = ""
        if self.metrics is not None:
            self.metrics.autoscaler_freeze_total.inc()
        tel = self.gateway.telemetry
        if tel is not None:
            tel.observe_autoscale("freeze")
        self._record(now, "fleet", "freeze", None, [reason], done)

    # -- pressure signals --------------------------------------------------

    @staticmethod
    def _fast_burns(obj: Optional[dict]) -> Optional[dict]:
        """The two fastest-window burns out of an SLO objective report
        (keys like '60s'; the engine's windows are configurable)."""
        if not obj:
            return None
        burn = obj.get("burn") or {}
        keys = sorted(burn, key=lambda k: int(k[:-1]))[:2]
        if len(keys) < 2:
            return None
        return {k: burn[k] for k in keys}

    @staticmethod
    def _member_fills(fleet: dict, in_ring) -> list:
        fills = fleet.get("replica_batch_fill") or {}
        return [fills[ep] for ep in in_ring
                if isinstance(fills.get(ep), (int, float))]

    def _up_pressure(self, tier: str, slo: dict, snap: dict,
                     in_ring) -> list:
        cfg = self.config
        objs = slo.get("objectives", {})
        fleet = snap.get("fleet", {})
        reasons = []
        for name in TIER_OBJECTIVES[tier]:
            burns = self._fast_burns(objs.get(name))
            if burns and all(b >= cfg.up_burn for b in burns.values()):
                pretty = ", ".join(f"{k}={v:.2f}" for k, v in burns.items())
                reasons.append(
                    f"slo {name}: burn {pretty} >= {cfg.up_burn:g} "
                    f"in both fast windows"
                )
        if tier in ("prefill", "fused"):
            thr = (objs.get("queue_wait_p95") or {}).get("threshold")
            if thr:
                qw = fleet.get("replica_queue_wait_p95_s") or {}
                hot = sorted(
                    ep for ep in in_ring
                    if isinstance(qw.get(ep), (int, float))
                    and qw[ep] > thr
                )
                if hot:
                    reasons.append(
                        f"queue-wait p95 over {thr:g}s on "
                        f"{', '.join(hot)}"
                    )
        if tier in ("decode", "fused"):
            fills = self._member_fills(fleet, in_ring)
            if fills:
                mean = sum(fills) / len(fills)
                if mean >= cfg.high_batch_fill:
                    reasons.append(
                        f"mean batch fill {mean:.2f} >= "
                        f"{cfg.high_batch_fill:g}"
                    )
        return reasons

    def _down_pressure(self, tier: str, slo: dict, snap: dict,
                       in_ring) -> list:
        """Ebb requires EVERY signal quiet: burns at/under down_burn in
        both fast windows, idle member queues, low batch fill."""
        cfg = self.config
        objs = slo.get("objectives", {})
        fleet = snap.get("fleet", {})
        for name in TIER_OBJECTIVES[tier]:
            burns = self._fast_burns(objs.get(name))
            if burns is None or any(b > cfg.down_burn
                                    for b in burns.values()):
                return []
        qdepth = fleet.get("replica_queue_depth") or {}
        queued = sum(
            qdepth[ep] for ep in in_ring
            if isinstance(qdepth.get(ep), (int, float))
        )
        if queued > 0:
            return []
        if tier in ("prefill", "fused"):
            thr = (objs.get("queue_wait_p95") or {}).get("threshold")
            if thr:
                qw = fleet.get("replica_queue_wait_p95_s") or {}
                if any(isinstance(qw.get(ep), (int, float))
                       and qw[ep] > thr for ep in in_ring):
                    return []
        reasons = [f"burns <= {cfg.down_burn:g} in both fast windows; "
                   f"member queues idle"]
        if tier in ("decode", "fused"):
            fills = self._member_fills(fleet, in_ring)
            if fills:
                mean = sum(fills) / len(fills)
                if mean > cfg.low_batch_fill:
                    return []
                reasons.append(
                    f"mean batch fill {mean:.2f} <= "
                    f"{cfg.low_batch_fill:g}"
                )
        return reasons

    # -- per-tier evaluation -----------------------------------------------

    def _evaluate_tier(self, tier: str, gwstats: dict, slo: dict,
                       snap: dict, now: float, done: list) -> None:
        st = self._tier_state.setdefault(tier, _TierState())
        reps = gwstats.get("replicas", {})
        if tier == "fused":
            members = dict(reps)
        else:
            members = {ep: r for ep, r in reps.items()
                       if r.get("role") == tier}
        in_ring = sorted(ep for ep, r in members.items()
                         if r.get("in_ring"))
        with self._lock:
            self._tier_sizes[tier] = len(in_ring)
        if self.metrics is not None:
            self.metrics.autoscaler_replicas.labels(tier=tier).set(
                len(in_ring)
            )
        up = self._up_pressure(tier, slo, snap, in_ring)
        down = [] if up else self._down_pressure(tier, slo, snap, in_ring)
        with self._lock:
            if up:
                st.up_streak += 1
                st.down_streak = 0
            elif down:
                st.down_streak += 1
                st.up_streak = 0
            else:
                st.up_streak = st.down_streak = 0
                st.last_hold_key = ""
        if up and st.up_streak >= self.config.up_consecutive:
            self._try_scale_up(tier, st, in_ring, up, now, done)
        elif down and st.down_streak >= self.config.down_consecutive:
            self._try_scale_down(tier, st, gwstats, members, in_ring, down,
                                 now, done)

    def _rate_limit_ok(self, now: float) -> bool:
        with self._lock:
            cutoff = now - self.config.actions_window_s
            while self._action_times and self._action_times[0] <= cutoff:
                self._action_times.popleft()
            return len(self._action_times) < self.config.max_actions_per_window

    def _try_scale_up(self, tier: str, st: _TierState, in_ring,
                      reasons: list, now: float, done: list) -> None:
        cfg = self.config
        if len(in_ring) >= cfg.max_replicas:
            self._hold(now, tier, st, "max",
                       f"at max_replicas={cfg.max_replicas}", reasons,
                       done)
            return
        if now < st.claim_backoff_until:
            self._hold(now, tier, st, "backoff",
                       f"claim backoff {st.claim_backoff_until - now:.1f}s "
                       f"remaining after {st.claim_failures} failure(s)",
                       reasons, done)
            return
        if now < st.up_cooldown_until:
            self._hold(now, tier, st, "cooldown_up",
                       f"up cooldown {st.up_cooldown_until - now:.1f}s "
                       f"remaining", reasons, done)
            return
        if not self._rate_limit_ok(now):
            self._hold(now, tier, st, "rate_limit",
                       f"rate limit: {cfg.max_actions_per_window} actions "
                       f"per {cfg.actions_window_s:g}s", reasons, done)
            return
        with self._lock:
            self._claim_attempts += 1
        if self.metrics is not None:
            self.metrics.autoscaler_claim_attempts_total.inc()
        t0 = time.perf_counter()
        err = None
        try:
            # The claim walk (k8s list + slice claim + provisioner HTTP)
            # runs unlocked: only _tick_lock single-flights it.
            got = self.provisioner.scale_up(tier, now=now)
        except Exception as exc:  # a claim error is a failure, not a crash
            got, err = None, repr(exc)
        latency = time.perf_counter() - t0
        with self._lock:
            self._claim_latency_last = latency
        if self.metrics is not None:
            self.metrics.autoscaler_claim_latency_seconds.set(latency)
        if got is None:
            with self._lock:
                st.claim_failures += 1
                self._claim_failures += 1
                backoff = min(
                    cfg.claim_backoff_base_s * 2 ** (st.claim_failures - 1),
                    cfg.claim_backoff_max_s,
                ) * (1.0 + cfg.claim_backoff_jitter * self.rng())
                st.claim_backoff_until = now + backoff
            if self.metrics is not None:
                self.metrics.autoscaler_claim_failures_total.inc()
            why = (f"warm-slice claim failed"
                   f"{' (' + err + ')' if err else ''}; holding capacity, "
                   f"backoff {backoff:.1f}s")
            self._hold(now, tier, st, "claim_failed", why, reasons, done,
                       force=True)
            return
        with self._lock:
            st.claim_failures = 0
            st.claim_backoff_until = 0.0
            st.up_cooldown_until = now + cfg.up_cooldown_s
            st.up_streak = 0
            st.last_hold_key = ""
            self._action_times.append(now)
            self._scale_ups += 1
        if self.metrics is not None:
            self.metrics.autoscaler_scale_up_total.inc()
        tel = self.gateway.telemetry
        if tel is not None:
            tel.observe_autoscale("up")
        self._record(
            now, tier, "scale_up", str(got),
            reasons + [f"claimed {got} in {latency * 1000:.0f}ms"],
            done,
        )

    def _try_scale_down(self, tier: str, st: _TierState, gwstats: dict,
                        members: dict, in_ring, reasons: list, now: float,
                        done: list) -> None:
        cfg = self.config
        if len(in_ring) <= cfg.min_replicas:
            self._hold(now, tier, st, "min",
                       f"at min_replicas={cfg.min_replicas}", reasons,
                       done)
            return
        if now < st.down_cooldown_until:
            self._hold(now, tier, st, "cooldown_down",
                       f"down cooldown {st.down_cooldown_until - now:.1f}s "
                       f"remaining", reasons, done)
            return
        if not self._rate_limit_ok(now):
            self._hold(now, tier, st, "rate_limit",
                       f"rate limit: {cfg.max_actions_per_window} actions "
                       f"per {cfg.actions_window_s:g}s", reasons, done)
            return

        def _load(ep):
            s = members[ep].get("stats") or {}
            return ((s.get("active_slots") or 0) + (s.get("queued") or 0),
                    ep)

        # A live migration restoring onto a replica pins it: draining it
        # now would release the very slice the migration is landing on.
        pinned_fn = getattr(self.gateway, "migration_pinned", None)
        pinned = pinned_fn() if pinned_fn is not None else frozenset()
        eligible = [ep for ep in in_ring if ep not in pinned]
        if not eligible:
            self._hold(
                now, tier, st, "migration_pinned",
                f"all {len(in_ring)} in-ring replicas are migration "
                f"restore targets; holding scale-down", reasons, done,
            )
            return
        victim = min(eligible, key=_load)
        # Headroom guard over the WHOLE fleet: the capacity left after
        # this removal must still cover every in-flight stream with
        # margin, or tenant-fair admission could start shedding a tenant
        # that is under its fair share. Capacity mirrors the gateway's
        # own heuristic (2× slots per ring node, 16 unknown).
        total_inflight = sum((gwstats.get("inflight") or {}).values())
        cap_after = 0
        for ep, r in gwstats.get("replicas", {}).items():
            if ep == victim or not r.get("in_ring"):
                continue
            slots = (r.get("stats") or {}).get("slots")
            cap_after += 2 * slots if slots else 16
        if total_inflight * cfg.headroom > cap_after:
            self._hold(
                now, tier, st, "headroom",
                f"insufficient headroom: {total_inflight} in-flight × "
                f"{cfg.headroom:g} > capacity {cap_after} after removing "
                f"{victim} (would risk shedding an under-share tenant)",
                reasons, done,
            )
            return
        try:
            self.provisioner.drain(victim)
        except Exception as exc:
            self._hold(now, tier, st, "drain_failed",
                       f"drain({victim}) failed: {exc!r}", reasons, done,
                       force=True)
            return
        # Out of the ring the instant the drain starts: new streams
        # route elsewhere, in-flight ones keep flowing to the victim.
        self.gateway.begin_drain(victim)
        with self._lock:
            self._draining[victim] = {
                "tier": tier, "since": now,
                "deadline": now + cfg.drain_budget_s,
            }
            st.down_cooldown_until = now + cfg.down_cooldown_s
            st.down_streak = 0
            st.last_hold_key = ""
            self._action_times.append(now)
            self._scale_downs += 1
        if self.metrics is not None:
            self.metrics.autoscaler_scale_down_total.inc()
        tel = self.gateway.telemetry
        if tel is not None:
            tel.observe_autoscale("down")
        self._record(
            now, tier, "scale_down", victim,
            reasons + [f"least-loaded of {len(in_ring)} in-ring; "
                       f"drain budget {cfg.drain_budget_s:g}s"],
            done,
        )

    def _advance_drains(self, now: float, done: list) -> None:
        # Snapshot under the lock, poll the provisioner (HTTP) outside it:
        # a slow drained() probe must not block stats()/debug() readers.
        with self._lock:
            draining = {ep: dict(d) for ep, d in self._draining.items()}
        for ep in sorted(draining):
            d = draining[ep]
            over = now >= d["deadline"]
            try:
                idle = self.provisioner.drained(ep)
            except Exception:
                idle = False
            if not idle and not over:
                continue
            with self._lock:
                if self._draining.pop(ep, None) is None:
                    continue  # raced with a concurrent reconfigure
            reasons = []
            if idle:
                reasons.append(
                    f"drained in {now - d['since']:.1f}s; slice released"
                )
            else:
                reasons.append(
                    f"drain budget {self.config.drain_budget_s:g}s "
                    f"exceeded; releasing (replica's own drain deadline "
                    f"ends its remaining work)"
                )
            try:
                self.provisioner.release(ep)
            except Exception as exc:
                reasons.append(f"release failed: {exc!r}")
            self.gateway.remove_replica(ep)
            self._record(now, d["tier"], "release", ep, reasons, done)

    # -- recording ---------------------------------------------------------

    def _hold(self, now: float, tier: str, st: _TierState, kind: str,
              why: str, pressure: list, done: list, *,
              force: bool = False) -> None:
        with self._lock:
            if not force and st.last_hold_key == kind:
                return  # same suppression as last tick: one hold per episode
            st.last_hold_key = kind
            self._holds += 1
        if self.metrics is not None:
            self.metrics.autoscaler_hold_total.inc()
        tel = self.gateway.telemetry
        if tel is not None:
            tel.observe_autoscale("hold")
        self._record(now, tier, "hold", None, list(pressure) + [why], done)

    def _record(self, now: float, tier: str, action: str,
                endpoint: Optional[str], reasons: list,
                done: list) -> None:
        entry = {"t": round(now, 3), "tier": tier, "action": action,
                 "reasons": list(reasons)}
        if endpoint:
            entry["endpoint"] = endpoint
        with self._lock:
            self._decisions.append(entry)
        done.append(entry)
        if tracing.enabled():
            attrs = {"autoscaler.tier": tier,
                     "autoscaler.action": action}
            if endpoint:
                attrs["autoscaler.endpoint"] = endpoint
            sp = tracing.get_tracer("autoscaler").begin_span(
                f"autoscaler.{action}", **attrs
            )
            sp.add_event("autoscaler.reasons",
                         {"reasons": "; ".join(reasons)})
            sp.end()

    # -- surfaces ----------------------------------------------------------

    def stats(self) -> dict:
        """The /stats block; its keys are the reference's, the surface of
        the tpu_autoscaler_* metric families."""
        with self._lock:
            return {
                "enabled": True,
                "frozen": self._frozen,
                "scale_ups": self._scale_ups,
                "scale_downs": self._scale_downs,
                "holds": self._holds,
                "freezes": self._freezes,
                "claim_attempts": self._claim_attempts,
                "claim_failures": self._claim_failures,
                "claim_latency_s": round(self._claim_latency_last, 6),
                "tier_replicas": dict(sorted(self._tier_sizes.items())),
                "draining": sorted(self._draining),
            }

    def debug(self) -> dict:
        """The /debug/autoscaler payload: config, per-tier loop state,
        in-progress drains, and the decision ring (newest last)."""
        with self._lock:
            return {
                **self.stats(),
                "config": dataclasses.asdict(self.config),
                "tiers": {
                    tier: {
                        "size": self._tier_sizes.get(tier, 0),
                        "up_streak": st.up_streak,
                        "down_streak": st.down_streak,
                        "up_cooldown_until": round(st.up_cooldown_until, 3),
                        "down_cooldown_until": round(
                            st.down_cooldown_until, 3
                        ),
                        "claim_failures": st.claim_failures,
                        "claim_backoff_until": round(
                            st.claim_backoff_until, 3
                        ),
                    }
                    for tier, st in sorted(self._tier_state.items())
                },
                "draining": {
                    ep: {k: round(v, 3) if isinstance(v, float) else v
                         for k, v in d.items()}
                    for ep, d in sorted(self._draining.items())
                },
                "decisions": list(self._decisions),
            }


def autoscaler_from_env() -> Optional[AutoscalerConfig]:
    """None unless KUBEFLOW_TPU_AUTOSCALE_ENABLE opts in (the autoscaler
    must be inert by default). Raises on garbage — a hand-set env var
    must not silently fall back to defaults."""
    import os

    raw = os.environ.get(KUBEFLOW_TPU_AUTOSCALE_ENABLE, "").strip().lower()
    if raw not in ("", "0", "false", "1", "true"):
        raise ValueError(
            f"{KUBEFLOW_TPU_AUTOSCALE_ENABLE}={raw!r}: want 0/1/true/false"
        )
    if raw not in ("1", "true"):
        return None
    defaults = AutoscalerConfig()

    def _num(name, default, minimum, cast):
        value = os.environ.get(name, "").strip()
        if not value:
            return default
        try:
            got = cast(value)
        except ValueError:
            got = minimum - 1
        if got < minimum:
            raise ValueError(f"{name}={value!r}: want a number >= {minimum}")
        return got

    return AutoscalerConfig(
        min_replicas=_num(KUBEFLOW_TPU_AUTOSCALE_MIN_REPLICAS,
                          defaults.min_replicas, 0, int),
        max_replicas=_num(KUBEFLOW_TPU_AUTOSCALE_MAX_REPLICAS,
                          defaults.max_replicas, 1, int),
        up_cooldown_s=float(_num(KUBEFLOW_TPU_AUTOSCALE_UP_COOLDOWN_S,
                                 defaults.up_cooldown_s, 0, float)),
        down_cooldown_s=float(_num(KUBEFLOW_TPU_AUTOSCALE_DOWN_COOLDOWN_S,
                                   defaults.down_cooldown_s, 0, float)),
        max_actions_per_window=_num(KUBEFLOW_TPU_AUTOSCALE_MAX_ACTIONS,
                                    defaults.max_actions_per_window, 1,
                                    int),
        actions_window_s=float(_num(KUBEFLOW_TPU_AUTOSCALE_WINDOW_S,
                                    defaults.actions_window_s, 1, float)),
        drain_budget_s=float(_num(KUBEFLOW_TPU_AUTOSCALE_DRAIN_BUDGET_S,
                                  defaults.drain_budget_s, 1, float)),
        stale_after_s=float(_num(KUBEFLOW_TPU_AUTOSCALE_STALE_AFTER_S,
                                 defaults.stale_after_s, 1, float)),
    )
