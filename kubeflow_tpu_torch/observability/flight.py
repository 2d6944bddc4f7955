"""Engine flight recorder: a rolling window of step times with stall
detection, and the stall-triggered profile capture.

The port's own copy of ``kubeflow_tpu/observability/flight.py``. The
per-request spans answer "where did THIS request's time go"; the flight
recorder answers "what has the engine been doing for the last N steps",
cheaply enough (a deque append a step) to stay on always, traced or not.
The server shows ``snapshot()`` under ``/stats`` and mirrors the stall
count into a metrics bundle's ``engine_step_stall_total``.

Stall rule: a step is a stall when it takes more than ``stall_factor`` ×
the rolling median of the window, once ``min_samples`` steps are in it
(the guard keeps the first steps, which build kernels and warm caches,
from being flagged or from flagging the steps after them).

A stall can start a profile capture: ``on_stall`` is called with the stall
ledger entry, outside the recorder's lock, so a slow callback never holds
up the engine's next ``record_step``. The server wires
:class:`StallProfiler` in when ``KUBEFLOW_TPU_STALL_PROFILE_DIR`` is set.
"""

from __future__ import annotations

import os
import pathlib
import statistics
import threading
import time
from collections import deque
from typing import Callable, Optional

# The port's own copies of the env contract names (the JAX package's
# webhook/tpu_env.py): setting the directory arms a bounded profile
# capture on engine stalls.
KUBEFLOW_TPU_STALL_PROFILE_DIR = "KUBEFLOW_TPU_STALL_PROFILE_DIR"
KUBEFLOW_TPU_STALL_PROFILE_COOLDOWN_S = "KUBEFLOW_TPU_STALL_PROFILE_COOLDOWN_S"
KUBEFLOW_TPU_STALL_PROFILE_SECONDS = "KUBEFLOW_TPU_STALL_PROFILE_SECONDS"


class FlightRecorder:
    """Thread-compatible: the engine drive loop records; HTTP handler
    threads snapshot. A lock keeps the window and counters coherent."""

    def __init__(
        self,
        window: int = 256,
        stall_factor: float = 8.0,
        min_samples: int = 16,
        clock: Optional[Callable[[], float]] = None,
    ):
        self.window = max(2, int(window))
        self.stall_factor = float(stall_factor)
        self.min_samples = max(2, int(min_samples))
        self.clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._durations: deque = deque(maxlen=self.window)
        self._fills: deque = deque(maxlen=self.window)
        self.steps = 0
        self.stalls = 0
        self.last_stall: Optional[dict] = None
        # Optional stall hook (e.g. StallProfiler.on_stall); called with
        # a copy of the ledger entry, outside the recorder lock.
        self.on_stall: Optional[Callable[[dict], object]] = None

    def record_step(
        self, duration_s: float, fill: Optional[float] = None
    ) -> bool:
        """Record one engine step; returns True when the step is a stall
        (caller attaches the span event / bumps the counter)."""
        with self._lock:
            stalled = False
            if len(self._durations) >= self.min_samples:
                median = statistics.median(self._durations)
                if median > 0 and duration_s > self.stall_factor * median:
                    stalled = True
                    self.stalls += 1
                    self.last_stall = {
                        "at": self.clock(),
                        "step": self.steps,
                        "duration_s": duration_s,
                        "median_s": median,
                        "factor": duration_s / median,
                    }
            self._durations.append(duration_s)
            if fill is not None:
                self._fills.append(fill)
            self.steps += 1
            info = dict(self.last_stall) if stalled else None
        if stalled and self.on_stall is not None:
            self.on_stall(info)
        return stalled

    def snapshot(self) -> dict:
        """Point-in-time view for ``/stats``: recent step-time distribution,
        fill, and the stall ledger."""
        with self._lock:
            durations = sorted(self._durations)
            n = len(durations)

            def pct(p: float) -> float:
                if not n:
                    return 0.0
                return durations[min(n - 1, int(p * n))]

            return {
                "steps": self.steps,
                "window": n,
                "stalls": self.stalls,
                "last_stall": dict(self.last_stall) if self.last_stall else None,
                "step_s": {
                    "p50": pct(0.50),
                    "p95": pct(0.95),
                    "max": durations[-1] if n else 0.0,
                },
                "fill": {
                    "mean": (
                        sum(self._fills) / len(self._fills)
                        if self._fills
                        else 0.0
                    ),
                },
            }


class StallProfiler:
    """Turns a stall into a bounded profiler trace.

    Wired as ``FlightRecorder.on_stall``: on a stall it starts a daemon
    thread that runs ``observability.profiling.trace`` for ``duration_s``
    seconds, capturing the steps *after* the stall (the stall itself has
    happened; what matters is whether the engine is still slow). Bounded
    three ways: at most one capture in flight, at most one a
    ``cooldown_s``, each ``duration_s`` long. Skipped stalls are counted,
    never queued. The profiler is imported only inside the capture
    thread; ``trace_fn`` is injectable for tests.
    """

    def __init__(self, log_dir, *, cooldown_s: float = 300.0,
                 duration_s: float = 2.0,
                 clock: Optional[Callable[[], float]] = None,
                 trace_fn: Optional[Callable] = None):
        if cooldown_s < 0:
            raise ValueError(f"cooldown_s must be >= 0, got {cooldown_s}")
        if duration_s <= 0:
            raise ValueError(f"duration_s must be > 0, got {duration_s}")
        self.log_dir = pathlib.Path(log_dir)
        self.cooldown_s = float(cooldown_s)
        self.duration_s = float(duration_s)
        self.clock = clock or time.monotonic
        self._trace_fn = trace_fn
        self._lock = threading.Lock()
        self._active = False
        self._last_start: Optional[float] = None
        self._seq = 0
        self.skipped = 0
        self.captures: list = []
        self.last_error: Optional[str] = None

    def on_stall(self, info: Optional[dict]) -> bool:
        """FlightRecorder callback; returns True when a capture starts.
        Never raises — the engine drive loop is above this call."""
        with self._lock:
            now = self.clock()
            in_cooldown = (
                self._last_start is not None
                and now - self._last_start < self.cooldown_s
            )
            if self._active or in_cooldown:
                self.skipped += 1
                return False
            self._active = True
            self._last_start = now
            self._seq += 1
            seq = self._seq
        threading.Thread(
            target=self._capture,
            args=(dict(info or {}), seq),
            name=f"stall-profile-{seq}",
            daemon=True,
        ).start()
        return True

    def _capture(self, info: dict, seq: int) -> None:
        try:
            trace_fn = self._trace_fn
            if trace_fn is None:
                from kubeflow_tpu_torch.observability.profiling import (
                    trace,
                )
                trace_fn = trace
            with trace_fn(self.log_dir, f"stall-{seq:03d}") as path:
                time.sleep(self.duration_s)
            with self._lock:
                self.captures.append({
                    "seq": seq,
                    "path": str(path),
                    "stall": info,
                })
        except Exception as exc:  # profiling must never hurt serving
            with self._lock:
                self.last_error = f"{type(exc).__name__}: {exc}"
        finally:
            with self._lock:
                self._active = False

    def summary(self) -> dict:
        """Surfaced under /stats next to the flight recorder's ledger."""
        with self._lock:
            return {
                "captures": len(self.captures),
                "skipped": self.skipped,
                "last": dict(self.captures[-1]) if self.captures else None,
                "last_error": self.last_error,
                "cooldown_s": self.cooldown_s,
            }


def stall_profiler_from_env(
    clock: Optional[Callable[[], float]] = None,
) -> Optional[StallProfiler]:
    """None unless KUBEFLOW_TPU_STALL_PROFILE_DIR is set (capture stays
    off by default). Raises on garbage knob values."""
    log_dir = os.environ.get(KUBEFLOW_TPU_STALL_PROFILE_DIR, "").strip()
    if not log_dir:
        return None

    def _positive(name, default, minimum):
        value = os.environ.get(name, "").strip()
        if not value:
            return default
        try:
            got = float(value)
        except ValueError:
            got = minimum - 1
        if got < minimum:
            raise ValueError(f"{name}={value!r}: want a number >= {minimum}")
        return got

    return StallProfiler(
        log_dir,
        cooldown_s=_positive(
            KUBEFLOW_TPU_STALL_PROFILE_COOLDOWN_S, 300.0, 0
        ),
        duration_s=_positive(KUBEFLOW_TPU_STALL_PROFILE_SECONDS, 2.0, 0.001),
        clock=clock,
    )
