"""controller-runtime analog: watch wiring, workqueue, reconcile loop.

The port's own copy of ``kubeflow_tpu/k8s/manager.py``. Controllers
declare the kinds they watch and how a watch event maps to reconcile
requests; the Manager drains the cluster's event stream into a
deduplicating queue and calls ``Reconciler.reconcile`` until nothing is
left (level-triggered reconciliation). Timed requeues sit on a heap of
(due time, sequence, registration, request), so ties dispatch in the order
they were scheduled, as the JAX package's do.
"""

from __future__ import annotations

import heapq
import logging
from dataclasses import dataclass
from typing import Callable, Optional, Protocol

from kubeflow_tpu_torch.k8s.fake import WatchEvent


class WatchSource(Protocol):
    """What the Manager needs from a cluster: an ordered event stream.

    FakeCluster (tests) and RealClient (production watch threads) both
    provide it — the reconcile loop is identical against either.
    """

    def drain_events(self, cursor: int) -> tuple[list[WatchEvent], int]: ...

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class Request:
    name: str
    namespace: str


@dataclass
class Result:
    requeue_after: float = 0.0  # seconds; 0 = no requeue


class Reconciler:
    """Base reconciler. Subclasses override reconcile()."""

    def reconcile(self, req: Request) -> Result:  # pragma: no cover - interface
        raise NotImplementedError


@dataclass
class _Watch:
    kind: str
    map_fn: Callable[[WatchEvent], list[Request]]


class FakeClock:
    """Deterministic clock for culling/requeue tests."""

    def __init__(self, start: float = 1_700_000_000.0):
        self._t = start

    def __call__(self) -> float:
        return self._t

    def now(self) -> float:
        return self._t

    def advance(self, seconds: float) -> None:
        self._t += seconds


class RealClock:
    """Wall clock for production serving: ``advance`` is a no-op (time
    advances itself), so ``Manager.tick(0)`` fires exactly the requeues
    that have actually come due."""

    def __call__(self) -> float:
        import time

        return time.time()

    def now(self) -> float:
        return self()

    def advance(self, seconds: float) -> None:
        pass


@dataclass
class _Registration:
    reconciler: Reconciler
    watches: list[_Watch]
    name: str


class Manager:
    """Drives registered reconcilers from the cluster's watch-event stream.

    ``run_until_idle`` is the test/e2e entrypoint: it drains events, maps
    them to requests, reconciles, and repeats until no new events or
    requests appear (bounded by ``max_cycles`` to catch livelock bugs).
    Timed requeues (Result.requeue_after) and the culler's periodic wakeups
    are driven by ``tick``.
    """

    def __init__(self, cluster: WatchSource, clock: Optional[FakeClock] = None):
        self.cluster = cluster
        self.clock = clock or FakeClock()
        self._registrations: list[_Registration] = []
        self._cursor = 0
        # (due_time, seq, registration_index, request) heap for requeues.
        # _pending coalesces per (reg, request) to the earliest due time,
        # as controller-runtime's workqueue AddAfter does — stale heap
        # entries are lazily skipped on pop.
        self._timers: list[tuple[float, int, int, Request]] = []
        self._pending: dict[tuple[int, Request], float] = {}
        self._timer_seq = 0
        # Reconcile exceptions seen since the last clear (error-masking
        # guard: tests asserting convergence can check this is empty).
        self.reconcile_errors: list[tuple[str, Request, Exception]] = []
        # Per-(reconciler, request) consecutive-failure counts driving the
        # retry backoff (controller-runtime workqueue: 5ms base doubling
        # to a cap; reset on the first success).
        self._failures: dict[tuple[int, Request], int] = {}

    RETRY_BASE_S = 0.005
    RETRY_CAP_S = 30.0

    @property
    def cursor(self) -> int:
        """Position in the event stream this manager has consumed up to —
        the value callers hand to ``client.wait_for_events`` to block for
        work (the serve loop's one dependency on manager internals)."""
        return self._cursor

    # -- registration ------------------------------------------------------

    def register(
        self,
        reconciler: Reconciler,
        for_kind: str,
        owns: tuple[str, ...] = (),
        watches: Optional[list[tuple[str, Callable[[WatchEvent], list[Request]]]]] = None,
        name: str = "",
    ) -> None:
        watch_list = [_Watch(for_kind, _primary_map_fn)]
        for kind in owns:
            watch_list.append(_Watch(kind, _owner_map_fn(for_kind)))
        for kind, fn in watches or []:
            watch_list.append(_Watch(kind, fn))
        self._registrations.append(
            _Registration(reconciler, watch_list, name or type(reconciler).__name__)
        )

    def watched_kinds(self) -> list[str]:
        """Union of kinds any registered reconciler watches (the set of
        watch streams a production serve loop must open)."""
        kinds: list[str] = []
        for reg in self._registrations:
            for watch in reg.watches:
                if watch.kind not in kinds:
                    kinds.append(watch.kind)
        return kinds

    # -- loop --------------------------------------------------------------

    def run_until_idle(self, max_cycles: int = 200) -> int:
        """Reconcile until quiescent. Returns number of reconcile calls."""
        calls = 0
        for _ in range(max_cycles):
            batch = self._collect_requests()
            if not batch:
                return calls
            for reg_idx, req in batch:
                calls += self._dispatch(reg_idx, req)
        raise RuntimeError(
            f"manager did not quiesce within {max_cycles} cycles "
            "(reconcilers keep mutating watched objects)"
        )

    def tick(self, seconds: float, max_cycles: int = 200) -> int:
        """Advance the clock and fire any requeues that came due."""
        self.clock.advance(seconds)
        calls = 0
        now = self.clock.now()
        while self._timers and self._timers[0][0] <= now:
            due, _, reg_idx, req = heapq.heappop(self._timers)
            # Skip stale entries superseded by a coalesced (earlier) timer.
            if self._pending.get((reg_idx, req)) != due:
                continue
            del self._pending[(reg_idx, req)]
            calls += self._dispatch(reg_idx, req)
        calls += self.run_until_idle(max_cycles)
        return calls

    def next_requeue_in(self) -> Optional[float]:
        live = [d for d in self._pending.values()]
        if not live:
            return None
        return max(0.0, min(live) - self.clock.now())

    def _schedule_requeue(self, reg_idx: int, req: Request, delay: float) -> None:
        key = (reg_idx, req)
        due = self.clock.now() + delay
        existing = self._pending.get(key)
        if existing is not None and existing <= due:
            return  # already scheduled sooner (or same) — coalesce
        self._pending[key] = due
        self._timer_seq += 1
        heapq.heappush(self._timers, (due, self._timer_seq, reg_idx, req))

    def _collect_requests(self) -> list[tuple[int, Request]]:
        events, self._cursor = self.cluster.drain_events(self._cursor)
        seen: set[tuple[int, Request]] = set()
        ordered: list[tuple[int, Request]] = []
        for ev in events:
            for reg_idx, reg in enumerate(self._registrations):
                for watch in reg.watches:
                    if watch.kind != ev.kind:
                        continue
                    for req in watch.map_fn(ev):
                        key = (reg_idx, req)
                        if key not in seen:
                            seen.add(key)
                            ordered.append(key)
        return ordered

    def _dispatch(self, reg_idx: int, req: Request) -> int:
        reg = self._registrations[reg_idx]
        key = (reg_idx, req)
        try:
            result = reg.reconciler.reconcile(req)
        except Exception as err:
            log.exception("%s: reconcile %s/%s failed", reg.name, req.namespace, req.name)
            # controller-runtime rate-limited requeue: exponential backoff
            # per item from a 5ms base — a transient write conflict retries
            # almost immediately instead of stalling the spawn path.
            fails = self._failures.get(key, 0) + 1
            self._failures[key] = fails
            self.reconcile_errors.append((reg.name, req, err))
            # Bound the error log for long-running serve loops; tests read
            # it between run_until_idle calls, long before 1000 entries.
            del self.reconcile_errors[:-1000]
            delay = min(self.RETRY_BASE_S * (2 ** (fails - 1)), self.RETRY_CAP_S)
            self._schedule_requeue(reg_idx, req, delay)
            return 1
        self._failures.pop(key, None)
        if result and result.requeue_after > 0:
            self._schedule_requeue(reg_idx, req, result.requeue_after)
        return 1


def _primary_map_fn(ev: WatchEvent) -> list[Request]:
    return [Request(ev.name, ev.namespace)]


def _owner_map_fn(owner_kind: str) -> Callable[[WatchEvent], list[Request]]:
    """Map an owned object's event to its controlling owner of ``owner_kind``.

    Matches controller-runtime's EnqueueRequestForOwner, which filters on the
    OwnerType — a Pod controlled by a StatefulSet must not enqueue a
    same-named Notebook.
    """

    def map_fn(ev: WatchEvent) -> list[Request]:
        for ref in ev.object.get("metadata", {}).get("ownerReferences", []):
            if ref.get("controller") and ref.get("kind") == owner_kind:
                return [Request(ref.get("name", ""), ev.namespace)]
        return []

    return map_fn
