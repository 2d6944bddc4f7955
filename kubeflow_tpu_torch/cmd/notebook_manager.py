"""Core notebook-controller manager entrypoint.

The port's counterpart of ``kubeflow_tpu/cmd/notebook_manager.py``, over
the port's reconcilers: ``python -m kubeflow_tpu_torch.cmd.notebook_manager``.
Reference parity — components/notebook-controller/main.go (148 LoC):
- flag parsing: metrics-addr, probe-addr, leader-election, burst, qps
  (main.go:65-72),
- scheme registration (main.go:48-56) — here the served version's dict
  objects (``kubeflow_tpu_torch.api.notebook``),
- NotebookReconciler always; CullingReconciler iff ENABLE_CULLING=true
  (main.go:111-123),
- healthz/readyz checks (main.go:125-133),
- leader election gating the reconcile loop (main.go:87-94).
"""

from __future__ import annotations

import argparse
import logging
import os
import threading
from dataclasses import dataclass, field
from typing import Optional

from kubeflow_tpu_torch.controller.culling import CullerConfig, CullingReconciler
from kubeflow_tpu_torch.controller.notebook import ControllerConfig, NotebookReconciler
from kubeflow_tpu_torch.controller.preemption import RecoveryConfig, SliceHealthReconciler
from kubeflow_tpu_torch.controller.prepull import PrePullConfig, PrePullReconciler
from kubeflow_tpu_torch.controller.slicepool import SlicePoolReconciler
from kubeflow_tpu_torch.k8s.client import Client
from kubeflow_tpu_torch.k8s.health import HealthChecks, HealthServer, ping
from kubeflow_tpu_torch.k8s.leader import UPSTREAM_LEASE, LeaderElector
from kubeflow_tpu_torch.k8s.manager import FakeClock, Manager, RealClock
from kubeflow_tpu_torch.k8s.serve import install_signal_handlers, serve, split_addr
from kubeflow_tpu_torch.metrics.metrics import Metrics


@dataclass
class Options:
    """CLI flags (reference main.go:65-72)."""

    metrics_addr: str = ":8080"
    probe_addr: str = ":8081"
    enable_leader_election: bool = False
    burst: int = 0
    qps: int = 0


def parse_args(argv: Optional[list[str]] = None) -> Options:
    parser = argparse.ArgumentParser(prog="notebook-controller")
    parser.add_argument("--metrics-addr", default=":8080")
    parser.add_argument("--probe-addr", default=":8081")
    parser.add_argument("--enable-leader-election", action="store_true")
    parser.add_argument("--burst", type=int, default=0)
    parser.add_argument("--qps", type=int, default=0)
    ns = parser.parse_args(argv or [])
    return Options(
        metrics_addr=ns.metrics_addr,
        probe_addr=ns.probe_addr,
        enable_leader_election=ns.enable_leader_election,
        burst=ns.burst,
        qps=ns.qps,
    )


@dataclass
class ManagerBundle:
    """Everything main() wires together, exposed for tests and e2e runs."""

    manager: Manager
    options: Options
    health: HealthChecks
    metrics: Metrics
    notebook_reconciler: NotebookReconciler
    culling_reconciler: Optional[CullingReconciler]
    preemption_reconciler: SliceHealthReconciler
    slicepool_reconciler: Optional[SlicePoolReconciler] = None
    prepull_reconciler: Optional["PrePullReconciler"] = None
    elector: Optional[LeaderElector] = None
    extra: dict = field(default_factory=dict)

    def run_until_idle(self, max_cycles: int = 200) -> int:
        """Reconcile loop, gated on leadership as mgr.Start is."""
        if self.elector and not self.elector.try_acquire():
            return 0
        return self.manager.run_until_idle(max_cycles)

    def tick(self, seconds: float) -> int:
        if self.elector and not self.elector.try_acquire():
            self.manager.clock.advance(seconds)
            return 0
        return self.manager.tick(seconds)


def build(
    cluster: Client,
    env: Optional[dict] = None,
    argv: Optional[list[str]] = None,
    clock: Optional[FakeClock] = None,
    identity: str = "notebook-controller-0",
    prober=None,
) -> ManagerBundle:
    """Assemble the manager exactly as main() does, against any cluster."""
    env = env or {}
    opts = parse_args(argv)
    manager = Manager(cluster, clock)

    metrics = Metrics(cluster)
    nb = NotebookReconciler(
        cluster,
        config=ControllerConfig.from_env(env),
        metrics=metrics,
        clock=manager.clock,
    )
    nb.register(manager)

    preemption = SliceHealthReconciler(
        cluster,
        metrics=metrics,
        clock=manager.clock,
        config=RecoveryConfig.from_env(env),
    )
    preemption.register(manager)

    # Warm slice pools: inert without SlicePool CRs, so always registered
    # (mirrors how Owns-watches cost nothing until objects exist).
    pools = SlicePoolReconciler(cluster, metrics=metrics, clock=manager.clock)
    pools.register(manager)

    # Gate style as culling (reference main.go:111-123), but the
    # reconciler ALWAYS registers: when the gate is off it reconciles an
    # empty desired set, so pods created by a previously-enabled run are
    # GC'd instead of orphaned (they carry no ownerReferences).
    prepull = PrePullReconciler(
        cluster, config=PrePullConfig.from_env(env), metrics=metrics,
        clock=manager.clock,
        enabled=env.get("ENABLE_IMAGE_PREPULL", "").lower() == "true",
    )
    prepull.register(manager)

    culler: Optional[CullingReconciler] = None
    culler_cfg = CullerConfig.from_env(env)
    # Reference main.go:111-123: culling controller only exists when enabled.
    if culler_cfg.enable_culling:
        if prober is None:
            # The native concurrent fan-out (built at first use; a failed
            # build raises); DEV mode keeps the localhost-proxy path.
            from kubeflow_tpu_torch.controller.prober import make_prober

            prober = make_prober(
                dev_proxy="http://localhost:8001" if culler_cfg.dev_mode else None
            )
        culler = CullingReconciler(
            cluster,
            config=culler_cfg,
            prober=prober,
            metrics=metrics,
            clock=manager.clock,
        )
        culler.register(manager)

    health = HealthChecks()
    health.add_healthz_check("healthz", ping)
    health.add_readyz_check("readyz", ping)

    elector = None
    if opts.enable_leader_election:
        elector = LeaderElector(
            cluster,
            UPSTREAM_LEASE,
            env.get("K8S_NAMESPACE", "kubeflow"),
            identity,
            clock=manager.clock,
        )

    return ManagerBundle(
        manager=manager,
        options=opts,
        health=health,
        metrics=metrics,
        notebook_reconciler=nb,
        culling_reconciler=culler,
        preemption_reconciler=preemption,
        slicepool_reconciler=pools,
        prepull_reconciler=prepull,
        elector=elector,
    )


def main(argv: Optional[list[str]] = None) -> int:
    """Process entrypoint (reference main.go:58-148): connect to the real
    apiserver, assemble the manager, serve probes, run until SIGTERM."""
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )
    from kubeflow_tpu_torch.k8s.real import ClusterConfig, RealClient

    import sys

    if argv is None:
        argv = sys.argv[1:]
    env = dict(os.environ)
    opts = parse_args(argv)
    client = RealClient(ClusterConfig.from_env(env))
    bundle = build(
        client,
        env=env,
        argv=argv,
        clock=RealClock(),
        identity=env.get("HOSTNAME", "notebook-controller-0"),
    )

    host, port = split_addr(opts.probe_addr)
    health_server = HealthServer(bundle.health, host=host, port=port)
    health_server.start()
    logging.getLogger(__name__).info(
        "notebook-controller up: probes on %s:%d", host, health_server.port
    )

    metrics_server = None
    if opts.metrics_addr and opts.metrics_addr != "0":
        from kubeflow_tpu_torch.metrics.server import MetricsServer

        mhost, mport = split_addr(opts.metrics_addr)
        metrics_server = MetricsServer(bundle.metrics, host=mhost, port=mport)
        metrics_server.start()

    stop = threading.Event()
    install_signal_handlers(stop)
    try:
        serve(bundle, client, stop)
    finally:
        health_server.stop()
        if metrics_server is not None:
            metrics_server.stop()
        client.stop()
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess e2e
    raise SystemExit(main())
