"""Declarative SLO objectives and multi-window burn-rate alerting.

The port's own copy of the JAX package's ``observability/slo.py``, with
the same names and arithmetic.

An :class:`Objective` names a signal in a :class:`SignalHub` and a
target ("TTFT p95 <= 500 ms with a 5% error budget"). The
:class:`SLOEngine` evaluates each objective over three horizons (fast 1m
and 5m, slow 30m) as a **burn rate**: the observed bad fraction over the
budgeted one. Burn 1.0 is exactly on budget.

- **fast alert**: burn >= ``fast_burn`` in BOTH fast windows;
- **slow alert**: burn >= ``slow_burn`` in the slow window;
- **breaching** latches on either and clears only once every burn is
  below ``clear_factor`` x its threshold, so an oscillating burn does not
  flap the alert;
- a window with fewer than ``min_events`` observations burns 0 (no
  traffic is not an outage).

A fresh breach bumps ``tpu_slo_breach_total`` on the metrics bundle the
caller passes and, when tracing is on, emits one ``slo.breach`` span with
the burns. Every evaluation refreshes the
``tpu_slo_burn_rate{objective,window}`` gauge.

Objective kinds:

- ``latency``: the fraction of histogram samples over ``threshold``
  (TTFT p95, inter-token p95);
- ``ratio``: a bad counter over a total counter (errors and sheds);
- ``gauge``: the fraction of recent windows where any child of a gauge
  exceeded ``threshold`` (a replica's queue-wait p95).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple

from kubeflow_tpu_torch.observability import tracing
from kubeflow_tpu_torch.observability.signals import SignalHub

_KINDS = ("latency", "ratio", "gauge")


# The port's own copies of the env contract names this module reads
# (the JAX package's webhook/tpu_env.py), under the same names.
KUBEFLOW_TPU_SLO_ERROR_BUDGET = "KUBEFLOW_TPU_SLO_ERROR_BUDGET"
KUBEFLOW_TPU_SLO_FAST_BURN = "KUBEFLOW_TPU_SLO_FAST_BURN"
KUBEFLOW_TPU_SLO_INTER_TOKEN_P95_MS = "KUBEFLOW_TPU_SLO_INTER_TOKEN_P95_MS"
KUBEFLOW_TPU_SLO_QUEUE_WAIT_P95_MS = "KUBEFLOW_TPU_SLO_QUEUE_WAIT_P95_MS"
KUBEFLOW_TPU_SLO_SLOW_BURN = "KUBEFLOW_TPU_SLO_SLOW_BURN"
KUBEFLOW_TPU_SLO_TTFT_P95_MS = "KUBEFLOW_TPU_SLO_TTFT_P95_MS"


@dataclass(frozen=True)
class Objective:
    """One SLO: a signal, a target, and an error budget."""

    name: str
    kind: str                 # "latency" | "ratio" | "gauge"
    signal: str               # hub signal the bad-fraction comes from
    threshold: float = 0.0    # latency/gauge: the "bad" line (seconds)
    total_signal: str = ""    # ratio: denominator counter
    budget: float = 0.05      # allowed bad fraction (error budget)
    description: str = ""

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(
                f"objective {self.name!r}: kind must be one of {_KINDS}, "
                f"got {self.kind!r}"
            )
        if not (0.0 < self.budget <= 1.0):
            raise ValueError(
                f"objective {self.name!r}: budget must be in (0, 1], "
                f"got {self.budget}"
            )
        if self.kind == "ratio" and not self.total_signal:
            raise ValueError(
                f"objective {self.name!r}: ratio kind needs total_signal"
            )
        if self.kind in ("latency", "gauge") and self.threshold <= 0:
            raise ValueError(
                f"objective {self.name!r}: {self.kind} kind needs a "
                f"threshold > 0"
            )


def default_objectives(*, ttft_p95_s: float = 0.5,
                       inter_token_p95_s: float = 0.2,
                       queue_wait_p95_s: float = 0.25,
                       budget: float = 0.05) -> Tuple[Objective, ...]:
    """The serving fleet's stock SLOs, thresholds overridable via
    KUBEFLOW_TPU_SLO_* (see slo_from_env). A latency objective with
    budget 0.05 reads as 'p95 ≤ threshold'."""
    return (
        Objective(
            "ttft_p95", "latency", "ttft_s", threshold=ttft_p95_s,
            budget=budget,
            description="gateway-measured time to first token",
        ),
        Objective(
            "inter_token_p95", "latency", "inter_token_s",
            threshold=inter_token_p95_s, budget=budget,
            description="gateway-measured gap between streamed tokens",
        ),
        Objective(
            "error_ratio", "ratio", "bad_requests",
            total_signal="requests", budget=budget,
            description="errors + sheds over all gateway requests",
        ),
        Objective(
            "queue_wait_p95", "gauge", "replica_queue_wait_p95_s",
            threshold=queue_wait_p95_s, budget=budget,
            description="windows where any replica's queue-wait p95 "
                        "exceeded the target",
        ),
    )


@dataclass
class _State:
    breaching: bool = False
    breaches_total: int = 0
    last_burns: dict = field(default_factory=dict)


class SLOEngine:
    """Evaluates objectives against a hub; owns breach latches."""

    def __init__(self, hub: SignalHub, objectives, *,
                 fast_windows: Tuple[float, float] = (60.0, 300.0),
                 slow_window: float = 1800.0,
                 fast_burn: float = 14.4, slow_burn: float = 2.0,
                 clear_factor: float = 0.5, min_events: int = 10,
                 clock: Optional[Callable[[], float]] = None,
                 metrics=None):
        objectives = tuple(objectives)
        names = [o.name for o in objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names: {names}")
        if not (fast_windows[0] < fast_windows[1] < slow_window):
            raise ValueError(
                "windows must be ordered fast[0] < fast[1] < slow, got "
                f"{fast_windows} / {slow_window}"
            )
        if not (0.0 < clear_factor < 1.0):
            raise ValueError(
                f"clear_factor must be in (0, 1), got {clear_factor}"
            )
        self.hub = hub
        self.objectives = objectives
        self.fast_windows = (float(fast_windows[0]), float(fast_windows[1]))
        self.slow_window = float(slow_window)
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        self.clear_factor = float(clear_factor)
        self.min_events = int(min_events)
        self.clock = clock or time.monotonic
        self.metrics = metrics
        self._lock = threading.Lock()
        self._state = {o.name: _State() for o in objectives}

    def _burn(self, obj: Objective, over_s: float, now: float) -> float:
        """Burn rate of one objective over one horizon; 0.0 when the
        horizon holds too little evidence to judge."""
        hub = self.hub
        if obj.kind == "latency":
            if hub.event_count(obj.signal, over_s, now=now) < self.min_events:
                return 0.0
            frac, _held = hub.fraction_over(
                obj.signal, obj.threshold, over_s, now=now
            )
            return frac / obj.budget
        if obj.kind == "ratio":
            total = hub.counter_sum(obj.total_signal, over_s, now=now)
            if total < self.min_events:
                return 0.0
            bad = hub.counter_sum(obj.signal, over_s, now=now)
            return (bad / total) / obj.budget
        # gauge: bad window-fraction; need >= 2 observed windows so one
        # scrape can't claim 100% badness.
        bad, total = hub.gauge_windows_over(
            obj.signal, obj.threshold, over_s, now=now
        )
        if total < 2:
            return 0.0
        return (bad / total) / obj.budget

    def evaluate(self, now: Optional[float] = None) -> dict:
        """One evaluation pass: burns per window, alert flags, latch
        transitions, metric + span emission. Cheap (pure dict math over
        the hub's rings) — the gateway runs it every probe interval."""
        now = self.clock() if now is None else now
        fast_a, fast_b = self.fast_windows
        report: dict = {"now": round(now, 3), "objectives": {},
                        "breaching": []}
        with self._lock:
            for obj in self.objectives:
                burns = {
                    f"{int(w)}s": self._burn(obj, w, now)
                    for w in (fast_a, fast_b, self.slow_window)
                }
                fast_alert = (burns[f"{int(fast_a)}s"] >= self.fast_burn
                              and burns[f"{int(fast_b)}s"] >= self.fast_burn)
                slow_alert = burns[f"{int(self.slow_window)}s"] >= self.slow_burn
                st = self._state[obj.name]
                newly = (fast_alert or slow_alert) and not st.breaching
                if newly:
                    st.breaching = True
                    st.breaches_total += 1
                elif st.breaching:
                    fast_clear = self.clear_factor * self.fast_burn
                    slow_clear = self.clear_factor * self.slow_burn
                    if (max(burns[f"{int(fast_a)}s"],
                            burns[f"{int(fast_b)}s"]) < fast_clear
                            and burns[f"{int(self.slow_window)}s"]
                            < slow_clear):
                        st.breaching = False
                st.last_burns = burns
                if self.metrics is not None:
                    for window, burn in burns.items():
                        self.metrics.slo_burn_rate.labels(
                            objective=obj.name, window=window
                        ).set(burn)
                    if newly:
                        self.metrics.slo_breach_total.labels(
                            objective=obj.name
                        ).inc()
                if newly and tracing.enabled():
                    sp = tracing.get_tracer("slo").begin_span(
                        "slo.breach",
                        **{
                            "slo.objective": obj.name,
                            "slo.kind": obj.kind,
                            "slo.budget": obj.budget,
                        },
                    )
                    sp.add_event("slo.burn", dict(burns))
                    sp.end()
                report["objectives"][obj.name] = {
                    "kind": obj.kind,
                    "threshold": obj.threshold,
                    "budget": obj.budget,
                    "burn": {k: round(v, 4) for k, v in burns.items()},
                    "fast_alert": fast_alert,
                    "slow_alert": slow_alert,
                    "breaching": st.breaching,
                    "breaches_total": st.breaches_total,
                }
                if st.breaching:
                    report["breaching"].append(obj.name)
        return report


def slo_from_env() -> tuple:
    """(objectives, engine_kwargs) from KUBEFLOW_TPU_SLO_*. Latency
    thresholds are milliseconds in the env (operator-friendly), seconds
    internally. Raises on garbage rather than guessing."""
    import os

    def _positive(name, default):
        value = os.environ.get(name, "").strip()
        if not value:
            return default
        try:
            got = float(value)
        except ValueError:
            got = 0.0
        if got <= 0:
            raise ValueError(f"{name}={value!r}: want a number > 0")
        return got

    budget = _positive(KUBEFLOW_TPU_SLO_ERROR_BUDGET, 0.05)
    if budget > 1.0:
        raise ValueError(
            f"{KUBEFLOW_TPU_SLO_ERROR_BUDGET}={budget}: want <= 1.0"
        )
    objectives = default_objectives(
        ttft_p95_s=_positive(KUBEFLOW_TPU_SLO_TTFT_P95_MS, 500.0) / 1000.0,
        inter_token_p95_s=_positive(
            KUBEFLOW_TPU_SLO_INTER_TOKEN_P95_MS, 200.0
        ) / 1000.0,
        queue_wait_p95_s=_positive(
            KUBEFLOW_TPU_SLO_QUEUE_WAIT_P95_MS, 250.0
        ) / 1000.0,
        budget=budget,
    )
    engine_kwargs = {
        "fast_burn": _positive(KUBEFLOW_TPU_SLO_FAST_BURN, 14.4),
        "slow_burn": _positive(KUBEFLOW_TPU_SLO_SLOW_BURN, 2.0),
    }
    return objectives, engine_kwargs
