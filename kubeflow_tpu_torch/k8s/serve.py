"""Production serve loop: the mgr.Start(ctx) analog.

The port's own copy of ``kubeflow_tpu/k8s/serve.py``.

The Manager itself is a synchronous drain-and-reconcile engine (testable
with FakeClock); this module runs it against a live watch stream until
stopped: fire due requeues, reconcile everything the watches surfaced,
then block on the event stream (or the next requeue deadline). Matches
the reference's blocking manager start + signal handler
(components/notebook-controller/main.go:141-147 ``mgr.Start(
ctrl.SetupSignalHandler())``).
"""

from __future__ import annotations

import logging
import signal
import threading
import time
from typing import Optional

log = logging.getLogger(__name__)


def install_signal_handlers(stop: threading.Event) -> None:
    """SIGTERM/SIGINT → graceful stop (ctrl.SetupSignalHandler analog)."""

    def _handler(signum, frame):
        log.info("signal %s: shutting down", signal.Signals(signum).name)
        stop.set()

    signal.signal(signal.SIGTERM, _handler)
    signal.signal(signal.SIGINT, _handler)


def split_addr(addr: str, default_host: str = "0.0.0.0") -> tuple[str, int]:
    """':8080' → ('0.0.0.0', 8080); 'localhost:9' → ('localhost', 9)."""
    host, _, port = addr.rpartition(":")
    return (host or default_host), int(port)


def serve(
    bundle,
    client,
    stop: Optional[threading.Event] = None,
    max_idle_wait: float = 1.0,
    max_iterations: int = 0,
    watchdog=None,
) -> None:
    """Drive ``bundle`` (a ManagerBundle or PlatformBundle) until ``stop``.

    ``client`` is the RealClient whose watch threads feed the manager's
    event stream; they are started here for exactly the kinds the
    registered reconcilers watch. Leadership gating lives in the bundle's
    ``tick``/``run_until_idle`` (non-leaders keep polling for the lease,
    as controller-runtime's leader election does).

    When the bundle exposes a ``health`` HealthChecks registry, a
    ServeWatchdog is registered on readyz (pass ``watchdog`` to override
    the default window): every successful drain cycle beats it, so a loop
    wedged in a hung call — or crash-looping every cycle — turns the
    replica unready instead of serving as a zombie.
    """
    stop = stop or threading.Event()
    manager = bundle.manager
    elector = getattr(bundle, "elector", None)
    watches_started = False

    health = getattr(bundle, "health", None)
    if watchdog is None and health is not None:
        from kubeflow_tpu_torch.k8s.health import ServeWatchdog

        watchdog = ServeWatchdog()
    if watchdog is not None and health is not None:
        watchdog.register(health)

    iterations = 0
    while not stop.is_set():
        # A standby replica never drains the event stream (tick() bails
        # before the manager runs), so its watches would accumulate events
        # unboundedly and waiting on the stream would return immediately
        # forever. Standbys therefore keep their watches unopened and just
        # sleep between lease-acquisition attempts.
        is_standby = elector is not None and not elector.try_acquire()
        if not is_standby and not watches_started:
            if hasattr(client, "start_watches"):
                client.start_watches(manager.watched_kinds())
            watches_started = True

        try:
            if hasattr(bundle, "tick"):
                bundle.tick(0)
            else:
                bundle.run_until_idle()
            if watchdog is not None:
                # Only a COMPLETED cycle beats: a loop that raises every
                # pass (or blocks inside tick) goes unready once the
                # watchdog window lapses.
                watchdog.beat(manager.cursor)
        except Exception:
            # A reconcile bug must not kill the process; level-triggered
            # retry will re-drive it (errors are also recorded on
            # manager.reconcile_errors).
            log.exception("reconcile cycle failed")
            time.sleep(0.5)

        iterations += 1
        if max_iterations and iterations >= max_iterations:
            return

        delay = manager.next_requeue_in()
        timeout = max_idle_wait if delay is None else max(0.0, min(delay, max_idle_wait))
        if not is_standby and hasattr(client, "wait_for_events"):
            client.wait_for_events(manager.cursor, timeout)
        else:
            stop.wait(timeout)
