"""Windowed fleet telemetry: the autoscaler's and the SLO engine's input.

The port's own copy of the JAX package's ``observability/signals.py``
(the port imports nothing of the JAX package, not even its JAX-free
modules), with the same names, windows and answers, so a port gateway's
``/debug/signals`` reads as the reference's does.

A fixed ring of aligned time windows (``windows`` x ``window_s``): the
window index is ``now // window_s``, so two series on one clock agree on
window boundaries, and a slot is reset lazily when its epoch comes round
again. The clock is injected, so everything here runs under a fake clock.

Three series kinds, registered on demand in a :class:`SignalHub`:

- **counter**: per-window sums and a lifetime total; ``rate()`` is
  events a second over any horizon (missing windows count as zero);
- **gauge**: the last value a window; ``windows_over()`` counts the
  recent windows above a threshold (the queue-wait SLO's shape);
- **histogram**: per-window bounded sample reservoirs, merged and sorted
  at query time, so ``quantile()`` is exact at small N. Past
  ``samples_per_window`` the reservoir overwrites its oldest sample.

:class:`FleetTelemetry` is the gateway-side aggregator. It ingests each
replica's ``/stats`` scrape (counter deltas and gauges), the gateway's
router events (requests, sheds and re-routes a tenant, bounded by
:class:`TenantBuckets`' top K plus ``other``) and the relay's TTFT and
inter-token latencies, and serves the snapshot behind ``/debug/signals``.
``signals_from_env`` builds nothing unless ``KUBEFLOW_TPU_SIGNALS_ENABLE``
opts in, so the default hot path carries a ``None``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

TENANT_OTHER = "other"


# The port's own copies of the env contract names this module reads
# (the JAX package's webhook/tpu_env.py), under the same names.
KUBEFLOW_TPU_SIGNALS_ENABLE = "KUBEFLOW_TPU_SIGNALS_ENABLE"
KUBEFLOW_TPU_SIGNALS_TENANTS = "KUBEFLOW_TPU_SIGNALS_TENANTS"
KUBEFLOW_TPU_SIGNALS_WINDOW_S = "KUBEFLOW_TPU_SIGNALS_WINDOW_S"
KUBEFLOW_TPU_SIGNALS_WINDOWS = "KUBEFLOW_TPU_SIGNALS_WINDOWS"


class TenantBuckets:
    """Bounded-cardinality tenant labels: the first ``top_k`` distinct
    tenants keep their own bucket, everyone later folds into ``other``.
    First-come is deliberate — a stable assignment that never re-labels
    an existing series mid-flight (a popularity-ranked top-K would), and
    the fleet's long-lived tenants are exactly the early ones."""

    def __init__(self, top_k: int = 8):
        if top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        self.top_k = top_k
        self._named: dict = {}
        self._lock = threading.Lock()

    def bucket(self, tenant: str) -> str:
        tenant = str(tenant)
        with self._lock:
            got = self._named.get(tenant)
            if got is not None:
                return got
            label = tenant if len(self._named) < self.top_k else TENANT_OTHER
            self._named[tenant] = label
            return label

    def buckets(self) -> list:
        """Every label currently in use (top-K names + maybe 'other')."""
        with self._lock:
            return sorted(set(self._named.values()))


class _Series:
    """Ring of aligned windows. Not thread-safe — the hub locks."""

    __slots__ = ("window_s", "windows", "_slots")

    def __init__(self, window_s: float, windows: int):
        self.window_s = window_s
        self.windows = windows
        self._slots: list = [None] * windows  # (epoch, payload)

    def _fresh(self):
        raise NotImplementedError

    def _slot(self, now: float):
        """Payload of the current window, resetting a stale ring slot."""
        epoch = int(now // self.window_s)
        i = epoch % self.windows
        slot = self._slots[i]
        if slot is None or slot[0] != epoch:
            slot = (epoch, self._fresh())
            self._slots[i] = slot
        return slot[1]

    def _live(self, over_s: float, now: float) -> list:
        """Payloads of the windows covering the last ``over_s`` seconds
        (current partial window included — an alert must see the most
        recent events, not wait a full window for them)."""
        epoch = int(now // self.window_s)
        k = min(self.windows, max(1, -(-int(over_s * 1000) // int(self.window_s * 1000))))
        out = []
        for e in range(epoch - k + 1, epoch + 1):
            slot = self._slots[e % self.windows]
            if slot is not None and slot[0] == e:
                out.append(slot[1])
        return out


class CounterSeries(_Series):
    __slots__ = ("total",)

    def __init__(self, window_s: float, windows: int):
        super().__init__(window_s, windows)
        self.total = 0.0

    def _fresh(self):
        return [0.0]

    def inc(self, now: float, value: float = 1.0) -> None:
        self._slot(now)[0] += value
        self.total += value

    def sum_over(self, over_s: float, now: float) -> float:
        return sum(w[0] for w in self._live(over_s, now))

    def rate(self, over_s: float, now: float) -> float:
        """Events/sec over the horizon. The denominator is the full
        requested span (missing windows were genuinely idle, not
        unknown), clamped to the ring's reach."""
        span = min(over_s, self.window_s * self.windows)
        return self.sum_over(over_s, now) / span if span > 0 else 0.0


class GaugeSeries(_Series):
    __slots__ = ("last",)

    def __init__(self, window_s: float, windows: int):
        super().__init__(window_s, windows)
        self.last: Optional[float] = None

    def _fresh(self):
        return [None]

    def set(self, now: float, value: float) -> None:
        self._slot(now)[0] = value
        self.last = value

    def windows_over(self, threshold: float, over_s: float,
                     now: float) -> tuple:
        """(windows where the gauge exceeded threshold, windows with any
        observation) over the horizon — the 'bad minutes' SLO shape."""
        vals = [w[0] for w in self._live(over_s, now) if w[0] is not None]
        return sum(1 for v in vals if v > threshold), len(vals)


class HistogramSeries(_Series):
    __slots__ = ("cap", "count")

    def __init__(self, window_s: float, windows: int, cap: int = 256):
        super().__init__(window_s, windows)
        self.cap = cap
        self.count = 0  # lifetime observations

    def _fresh(self):
        return {"n": 0, "samples": []}

    def observe(self, now: float, value: float) -> None:
        w = self._slot(now)
        if len(w["samples"]) < self.cap:
            w["samples"].append(value)
        else:
            w["samples"][w["n"] % self.cap] = value
        w["n"] += 1
        self.count += 1

    def merged(self, over_s: float, now: float) -> list:
        out: list = []
        for w in self._live(over_s, now):
            out.extend(w["samples"])
        out.sort()
        return out

    def events(self, over_s: float, now: float) -> int:
        """TRUE observation count over the horizon (reservoirs may hold
        fewer) — the min-events guard must see real traffic volume."""
        return sum(w["n"] for w in self._live(over_s, now))

    def quantile(self, q: float, over_s: float, now: float):
        xs = self.merged(over_s, now)
        if not xs:
            return None
        n = len(xs)
        return xs[min(n - 1, max(0, -(-int(q * 1000) * n // 1000) - 1))]

    def fraction_over(self, threshold: float, over_s: float,
                      now: float) -> tuple:
        """(fraction of held samples over threshold, held sample count).
        Computed over the reservoirs, so it is an estimate past the
        per-window cap — documented bias toward recent samples."""
        xs = self.merged(over_s, now)
        if not xs:
            return 0.0, 0
        bad = sum(1 for v in xs if v > threshold)
        return bad / len(xs), len(xs)


class SignalHub:
    """Named series registry with one lock and one clock.

    Series are keyed ``(name, child)`` — ``child=None`` is the
    aggregate; callers use children for per-tenant or per-replica
    breakdowns (cardinality is the CALLER's contract: tenants come
    pre-bucketed through TenantBuckets, replica children are bounded by
    the ring size). All record/query methods are thread-safe.
    """

    def __init__(self, window_s: float = 10.0, windows: int = 12,
                 clock: Optional[Callable[[], float]] = None,
                 samples_per_window: int = 256):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        if windows < 2:
            raise ValueError(f"windows must be >= 2, got {windows}")
        if samples_per_window < 1:
            raise ValueError(
                f"samples_per_window must be >= 1, got {samples_per_window}"
            )
        self.window_s = float(window_s)
        self.windows = int(windows)
        self.samples_per_window = int(samples_per_window)
        self.clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._counters: dict = {}
        self._gauges: dict = {}
        self._histograms: dict = {}

    def span_s(self) -> float:
        """The horizon the ring can answer about."""
        return self.window_s * self.windows

    def _now(self, now: Optional[float]) -> float:
        return self.clock() if now is None else now

    # -- recording ---------------------------------------------------------

    def inc(self, name: str, value: float = 1.0, child: Optional[str] = None,
            now: Optional[float] = None) -> None:
        now = self._now(now)
        with self._lock:
            s = self._counters.get((name, child))
            if s is None:
                s = self._counters[(name, child)] = CounterSeries(
                    self.window_s, self.windows
                )
            s.inc(now, value)

    def set_gauge(self, name: str, value: float,
                  child: Optional[str] = None,
                  now: Optional[float] = None) -> None:
        now = self._now(now)
        with self._lock:
            s = self._gauges.get((name, child))
            if s is None:
                s = self._gauges[(name, child)] = GaugeSeries(
                    self.window_s, self.windows
                )
            s.set(now, value)

    def observe(self, name: str, value: float, child: Optional[str] = None,
                now: Optional[float] = None) -> None:
        now = self._now(now)
        with self._lock:
            s = self._histograms.get((name, child))
            if s is None:
                s = self._histograms[(name, child)] = HistogramSeries(
                    self.window_s, self.windows, self.samples_per_window
                )
            s.observe(now, value)

    # -- queries -----------------------------------------------------------

    def rate(self, name: str, over_s: Optional[float] = None,
             child: Optional[str] = None,
             now: Optional[float] = None) -> float:
        now, over_s = self._now(now), over_s or self.span_s()
        with self._lock:
            s = self._counters.get((name, child))
            return s.rate(over_s, now) if s else 0.0

    def counter_sum(self, name: str, over_s: Optional[float] = None,
                    child: Optional[str] = None,
                    now: Optional[float] = None) -> float:
        now, over_s = self._now(now), over_s or self.span_s()
        with self._lock:
            s = self._counters.get((name, child))
            return s.sum_over(over_s, now) if s else 0.0

    def counter_total(self, name: str,
                      child: Optional[str] = None) -> float:
        with self._lock:
            s = self._counters.get((name, child))
            return s.total if s else 0.0

    def gauge_last(self, name: str, child: Optional[str] = None):
        with self._lock:
            s = self._gauges.get((name, child))
            return s.last if s else None

    def gauge_children(self, name: str) -> dict:
        with self._lock:
            return {
                child: s.last
                for (n, child), s in self._gauges.items()
                if n == name and child is not None and s.last is not None
            }

    def gauge_windows_over(self, name: str, threshold: float,
                           over_s: Optional[float] = None,
                           now: Optional[float] = None) -> tuple:
        """(bad, observed) windows across the aggregate AND every child
        of ``name`` — for a fleet gauge like per-replica queue wait, a
        window is bad when ANY replica exceeded the threshold."""
        now, over_s = self._now(now), over_s or self.span_s()
        bad = total = 0
        with self._lock:
            for (n, _child), s in self._gauges.items():
                if n != name:
                    continue
                b, t = s.windows_over(threshold, over_s, now)
                bad += b
                total += t
        return bad, total

    def quantile(self, name: str, q: float, over_s: Optional[float] = None,
                 child: Optional[str] = None, now: Optional[float] = None):
        now, over_s = self._now(now), over_s or self.span_s()
        with self._lock:
            s = self._histograms.get((name, child))
            return s.quantile(q, over_s, now) if s else None

    def fraction_over(self, name: str, threshold: float,
                      over_s: Optional[float] = None,
                      child: Optional[str] = None,
                      now: Optional[float] = None) -> tuple:
        now, over_s = self._now(now), over_s or self.span_s()
        with self._lock:
            s = self._histograms.get((name, child))
            return s.fraction_over(threshold, over_s, now) if s else (0.0, 0)

    def event_count(self, name: str, over_s: Optional[float] = None,
                    child: Optional[str] = None,
                    now: Optional[float] = None) -> int:
        now, over_s = self._now(now), over_s or self.span_s()
        with self._lock:
            s = self._histograms.get((name, child))
            return s.events(over_s, now) if s else 0

    def counter_children(self, name: str) -> list:
        with self._lock:
            return sorted(
                child for (n, child) in self._counters
                if n == name and child is not None
            )

    def histogram_children(self, name: str) -> list:
        with self._lock:
            return sorted(
                child for (n, child) in self._histograms
                if n == name and child is not None
            )


@dataclass(frozen=True)
class SignalsConfig:
    """Telemetry-plane shape: window size, ring length (the horizon must
    cover the SLO engine's slow window), tenant label cardinality."""

    window_s: float = 10.0
    windows: int = 180          # 30-minute horizon at 10s windows
    top_k_tenants: int = 8


def signals_from_env() -> Optional[SignalsConfig]:
    """None unless KUBEFLOW_TPU_SIGNALS_ENABLE opts in (the telemetry
    plane must be a hot-path no-op by default). Raises on garbage — a
    hand-set env var must not silently fall back to defaults."""
    import os

    raw = os.environ.get(KUBEFLOW_TPU_SIGNALS_ENABLE, "").strip().lower()
    if raw not in ("", "0", "false", "1", "true"):
        raise ValueError(
            f"{KUBEFLOW_TPU_SIGNALS_ENABLE}={raw!r}: want 0/1/true/false"
        )
    if raw not in ("1", "true"):
        return None
    defaults = SignalsConfig()

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

    return SignalsConfig(
        window_s=float(
            _num(KUBEFLOW_TPU_SIGNALS_WINDOW_S, defaults.window_s, 1, float)
        ),
        windows=_num(KUBEFLOW_TPU_SIGNALS_WINDOWS, defaults.windows, 2, int),
        top_k_tenants=_num(
            KUBEFLOW_TPU_SIGNALS_TENANTS, defaults.top_k_tenants, 1, int
        ),
    )


class FleetTelemetry:
    """Gateway-side signal plane: hub + tenant buckets + SLO engine.

    Feeds (all no-ops for the gateway when this object is None):

    - router events: ``observe_request`` / ``observe_shed`` /
      ``observe_reroute`` from the admission and relay paths, with TTFT
      and inter-token gaps measured AT THE RELAY (arrival → first SSE
      data line), so the numbers are what a client actually saw through
      the gateway, per tenant;
    - replica scrapes: ``ingest_replica`` turns each /stats payload into
      per-replica gauges and fleet counter DELTAS (cumulative counters
      re-based per endpoint; a replica restart resets its base instead
      of producing a negative spike).

    ``snapshot()`` is the SignalSnapshot contract ``/debug/signals``
    serves and the future autoscaler consumes; ``evaluate_slo()`` runs
    the burn-rate engine (the gateway's probe loop calls it every pass).
    """

    def __init__(self, config: Optional[SignalsConfig] = None, *,
                 objectives=None, metrics=None,
                 clock: Optional[Callable[[], float]] = None,
                 slo_options: Optional[dict] = None):
        from kubeflow_tpu_torch.observability.slo import (
            SLOEngine,
            default_objectives,
        )

        self.config = config or SignalsConfig()
        self.clock = clock or time.monotonic
        self.hub = SignalHub(
            window_s=self.config.window_s, windows=self.config.windows,
            clock=self.clock,
        )
        self.tenants = TenantBuckets(self.config.top_k_tenants)
        self.slo = SLOEngine(
            self.hub,
            objectives if objectives is not None else default_objectives(),
            clock=self.clock, metrics=metrics, **(slo_options or {}),
        )
        self._scrape_lock = threading.Lock()
        self._replica_base: dict = {}  # endpoint -> {stat: last cumulative}
        # endpoint -> clock() of the last *fresh* /stats ingest. The
        # autoscaler's staleness freeze reads this: a replica whose
        # scrape age grows past its threshold means the control loop is
        # flying blind and must hold capacity rather than act.
        self._replica_last_scrape: dict = {}

    @classmethod
    def from_env(cls, metrics=None,
                 clock: Optional[Callable[[], float]] = None
                 ) -> Optional["FleetTelemetry"]:
        config = signals_from_env()
        if config is None:
            return None
        from kubeflow_tpu_torch.observability.slo import slo_from_env

        objectives, slo_options = slo_from_env()
        return cls(config, objectives=objectives, metrics=metrics,
                   clock=clock, slo_options=slo_options)

    # -- router-side feeds -------------------------------------------------

    def observe_request(self, tenant: str, ok: bool,
                        ttft_s: Optional[float] = None,
                        inter_token=None,
                        e2e_s: Optional[float] = None) -> None:
        bucket = self.tenants.bucket(tenant)
        hub = self.hub
        hub.inc("requests")
        hub.inc("requests", child=bucket)
        if not ok:
            hub.inc("errors")
            hub.inc("errors", child=bucket)
            hub.inc("bad_requests")
        if ttft_s is not None:
            hub.observe("ttft_s", ttft_s)
            hub.observe("ttft_s", ttft_s, child=bucket)
        for gap in inter_token or ():
            hub.observe("inter_token_s", gap)
        if e2e_s is not None:
            hub.observe("request_s", e2e_s)

    def observe_shed(self, tenant: str) -> None:
        bucket = self.tenants.bucket(tenant)
        hub = self.hub
        hub.inc("requests")
        hub.inc("requests", child=bucket)
        hub.inc("shed")
        hub.inc("shed", child=bucket)
        hub.inc("bad_requests")

    def observe_reroute(self) -> None:
        self.hub.inc("reroutes")

    def observe_kv_transfer(self, nbytes: int, latency_s: float,
                            ok: bool = True) -> None:
        """One prefill→decode paged-KV handoff attempt (disaggregated
        serving): byte volume + hop latency, failures counted separately
        so /debug/signals can show the fallback rate next to the
        transfer rate."""
        hub = self.hub
        if ok:
            hub.inc("kv_transfers")
            hub.inc("kv_transfer_bytes", float(nbytes))
            hub.observe("kv_transfer_s", latency_s)
        else:
            hub.inc("kv_transfer_failures")

    def observe_kv_peer_fetch(self, nbytes: int, latency_s: float,
                              ok: bool = True) -> None:
        """One fleet-KV-tier peer prefix fetch attempt: byte volume +
        whole-fetch latency, failures counted separately so
        /debug/signals shows the degrade-to-re-prefill rate next to the
        fetch rate."""
        hub = self.hub
        if ok:
            hub.inc("kv_peer_fetches")
            hub.inc("kv_peer_bytes", float(nbytes))
            hub.observe("kv_peer_fetch_s", latency_s)
        else:
            hub.inc("kv_peer_fetch_failures")

    def ingest_ring(self, size: int) -> None:
        self.hub.set_gauge("ring_size", float(size))

    # -- replica-scrape feed -----------------------------------------------

    _REPLICA_COUNTERS = (
        ("served", "fleet_served"),
        ("requests_shed", "fleet_replica_shed"),
        ("tokens_generated", "fleet_tokens"),
        ("engine_step_stalls", "fleet_stalls"),
        # HBM economy: host-RAM swap-tier traffic. These live in the
        # nested /stats ``kv_swap`` block — a dotted path descends one
        # level per segment.
        ("kv_swap.swap_out", "fleet_kv_swap_out"),
        ("kv_swap.swap_in", "fleet_kv_swap_in"),
        ("kv_swap.restored_tokens", "fleet_kv_swap_restored_tokens"),
        # Speculative decoding: accepted proposals + verify rounds from
        # the /stats ``speculative`` block → fleet acceptance rates.
        ("speculative.accepted", "fleet_spec_accept"),
        ("speculative.rounds", "fleet_spec_rounds"),
        # Multi-LoRA: hot-adapter cache churn from the ``lora_cache``
        # block — the (prefix, adapter) affinity router's scoreboard.
        ("lora_cache.hits", "fleet_lora_cache_hits"),
        ("lora_cache.misses", "fleet_lora_cache_misses"),
        ("lora_cache.evictions", "fleet_lora_cache_evictions"),
    )

    def ingest_replica(self, endpoint: str, stats: Optional[dict]) -> None:
        if not stats:
            return
        hub = self.hub

        def _gauge(name, value):
            if isinstance(value, (int, float)) and not isinstance(
                    value, bool):
                hub.set_gauge(name, float(value), child=endpoint)

        _gauge("replica_queue_depth", stats.get("queued"))
        _gauge("replica_active_slots", stats.get("active_slots"))
        _gauge("replica_queue_wait_p95_s",
               (stats.get("queue_wait_s") or {}).get("p95"))
        _gauge("replica_inter_token_p95_s",
               (stats.get("inter_token_s") or {}).get("p95"))
        _gauge("replica_batch_fill",
               (stats.get("ragged") or {}).get("batch_fill"))
        _gauge("replica_prefix_hit_ratio",
               (stats.get("prefix_cache") or {}).get("hit_ratio"))
        _gauge("replica_kv_swap_bytes",
               (stats.get("kv_swap") or {}).get("swap_bytes"))
        with self._scrape_lock:
            self._replica_last_scrape[endpoint] = self.clock()
            base = self._replica_base.setdefault(endpoint, {})
            for stat, signal in self._REPLICA_COUNTERS:
                cur: object = stats
                for part in stat.split("."):
                    cur = cur.get(part) if isinstance(cur, dict) else None
                if not isinstance(cur, (int, float)) or isinstance(
                        cur, bool):
                    continue
                prev = base.get(stat)
                base[stat] = cur
                if prev is None:
                    continue  # first sight: establish the base only
                # A restarted replica's cumulative counter rebased to ~0:
                # count its fresh total, never a negative delta.
                delta = cur - prev if cur >= prev else cur
                if delta:
                    hub.inc(signal, float(delta))

    def forget_replica(self, endpoint: str) -> None:
        """Drop the per-endpoint rebase state and scrape timestamp for a
        replica that left the fleet — a departed (drained + released)
        replica's growing scrape age must not freeze the autoscaler, and
        a later re-add re-establishes its counter base from scratch."""
        with self._scrape_lock:
            self._replica_base.pop(endpoint, None)
            self._replica_last_scrape.pop(endpoint, None)

    def scrape_ages(self, now: Optional[float] = None) -> dict:
        """Per-endpoint seconds since the last fresh /stats ingest."""
        now = self.clock() if now is None else now
        with self._scrape_lock:
            return {
                ep: max(0.0, now - t)
                for ep, t in self._replica_last_scrape.items()
            }

    # -- autoscaler feed ---------------------------------------------------

    _AUTOSCALE_ACTIONS = ("up", "down", "hold", "freeze")

    def observe_autoscale(self, action: str) -> None:
        """One autoscaler decision, windowed so /debug/signals shows
        scale churn next to the load signals that caused it."""
        if action not in self._AUTOSCALE_ACTIONS:
            raise ValueError(
                f"autoscale action must be one of "
                f"{self._AUTOSCALE_ACTIONS}, got {action!r}"
            )
        self.hub.inc(f"autoscale_{action}")

    # -- migration feed ----------------------------------------------------

    _MIGRATION_EVENTS = ("started", "completed", "fell_back")

    def observe_migration(self, event: str) -> None:
        """One live-migration lifecycle event (runtime/migration.py),
        windowed so /debug/signals shows migration churn next to the
        preemption and load signals that triggered it."""
        if event not in self._MIGRATION_EVENTS:
            raise ValueError(
                f"migration event must be one of "
                f"{self._MIGRATION_EVENTS}, got {event!r}"
            )
        self.hub.inc(f"migration_{event}")

    # -- outputs -----------------------------------------------------------

    def evaluate_slo(self, now: Optional[float] = None) -> dict:
        return self.slo.evaluate(now=now)

    def snapshot(self, over_s: Optional[float] = None,
                 now: Optional[float] = None) -> dict:
        """The SignalSnapshot contract: fleet aggregates + per-tenant
        breakdowns over ``over_s`` (default: the whole ring horizon)."""
        hub = self.hub
        now = self.clock() if now is None else now
        over_s = over_s or hub.span_s()

        def _hist(name):
            return {
                "p50": hub.quantile(name, 0.50, over_s, now=now),
                "p95": hub.quantile(name, 0.95, over_s, now=now),
                "count": hub.event_count(name, over_s, now=now),
            }

        def _rate(name):
            return round(hub.rate(name, over_s, now=now), 6)

        tenants = {}
        for bucket in self.tenants.buckets():
            tenants[bucket] = {
                "requests_per_s": round(
                    hub.rate("requests", over_s, child=bucket, now=now), 6
                ),
                "requests": hub.counter_sum(
                    "requests", over_s, child=bucket, now=now
                ),
                "shed": hub.counter_sum(
                    "shed", over_s, child=bucket, now=now
                ),
                "errors": hub.counter_sum(
                    "errors", over_s, child=bucket, now=now
                ),
                "ttft_p95_s": hub.quantile(
                    "ttft_s", 0.95, over_s, child=bucket, now=now
                ),
            }
        return {
            "enabled": True,
            "now": round(now, 3),
            "window_s": hub.window_s,
            "windows": hub.windows,
            "over_s": over_s,
            "fleet": {
                "ttft_s": _hist("ttft_s"),
                "inter_token_s": _hist("inter_token_s"),
                "request_s": _hist("request_s"),
                "requests_per_s": _rate("requests"),
                "errors_per_s": _rate("errors"),
                "shed_per_s": _rate("shed"),
                "reroutes_per_s": _rate("reroutes"),
                # Disaggregated serving: KV handoff volume + hop latency.
                "kv_transfers_per_s": _rate("kv_transfers"),
                "kv_transfer_failures_per_s": _rate("kv_transfer_failures"),
                "kv_transfer_bytes_per_s": _rate("kv_transfer_bytes"),
                "kv_transfer_s": _hist("kv_transfer_s"),
                # Fleet KV tier: peer prefix fetch volume + latency.
                "kv_peer_fetches_per_s": _rate("kv_peer_fetches"),
                "kv_peer_fetch_failures_per_s": _rate(
                    "kv_peer_fetch_failures"
                ),
                "kv_peer_bytes_per_s": _rate("kv_peer_bytes"),
                "kv_peer_fetch_s": _hist("kv_peer_fetch_s"),
                # HBM economy: swap-tier churn as windowed rates, plus
                # the per-replica resident swap bytes.
                "kv_swap_out_per_s": _rate("fleet_kv_swap_out"),
                "kv_swap_in_per_s": _rate("fleet_kv_swap_in"),
                "kv_swap_restored_tokens_per_s": _rate(
                    "fleet_kv_swap_restored_tokens"
                ),
                "replica_kv_swap_bytes": hub.gauge_children(
                    "replica_kv_swap_bytes"
                ),
                "served_per_s": _rate("fleet_served"),
                "tokens_per_s": _rate("fleet_tokens"),
                "stalls_per_s": _rate("fleet_stalls"),
                # Speculative decoding + multi-LoRA serving rates.
                "spec_accept_per_s": _rate("fleet_spec_accept"),
                "spec_rounds_per_s": _rate("fleet_spec_rounds"),
                "lora_cache_hits_per_s": _rate("fleet_lora_cache_hits"),
                "lora_cache_misses_per_s": _rate(
                    "fleet_lora_cache_misses"
                ),
                "lora_cache_evictions_per_s": _rate(
                    "fleet_lora_cache_evictions"
                ),
                "ring_size": hub.gauge_last("ring_size"),
                "replica_queue_depth": hub.gauge_children(
                    "replica_queue_depth"
                ),
                "replica_queue_wait_p95_s": hub.gauge_children(
                    "replica_queue_wait_p95_s"
                ),
                "replica_batch_fill": hub.gauge_children(
                    "replica_batch_fill"
                ),
                "replica_prefix_hit_ratio": hub.gauge_children(
                    "replica_prefix_hit_ratio"
                ),
                # Staleness signal for the autoscaler freeze: seconds
                # since each replica's last fresh /stats ingest.
                "last_scrape_age_s": {
                    ep: round(age, 3)
                    for ep, age in sorted(self.scrape_ages(now=now).items())
                },
                # Autoscaler decision churn, windowed like every other
                # fleet rate so ramps and their scale actions line up.
                "autoscale_up_per_s": _rate("autoscale_up"),
                "autoscale_down_per_s": _rate("autoscale_down"),
                "autoscale_hold_per_s": _rate("autoscale_hold"),
                "autoscale_freeze_per_s": _rate("autoscale_freeze"),
                # Live-migration churn: starts vs completions vs ladder
                # fallbacks, windowed like the preemption signals above.
                "migration_started_per_s": _rate("migration_started"),
                "migration_completed_per_s": _rate("migration_completed"),
                "migration_fell_back_per_s": _rate("migration_fell_back"),
            },
            "tenants": tenants,
        }
