"""Platform (ODH-equivalent) manager entrypoint.

The port's counterpart of ``kubeflow_tpu/cmd/platform_manager.py``, over
the port's platform reconciler and admission webhooks:
``python -m kubeflow_tpu_torch.cmd.platform_manager
--kube-rbac-proxy-image IMAGE``. Reference parity — components/odh-notebook-controller/main.go (374 LoC):
- required ``--kube-rbac-proxy-image`` flag, validated before anything else
  (main.go:149-150,172-176),
- TLS security-profile fetch from the cluster APIServer CR with hardened
  fallback ciphers (main.go:71-78,183-234),
- cache transforms stripping ConfigMap/Secret payloads (main.go:95-125),
- controller-namespace detection (main.go:127-139),
- MLflow env config (main.go:286-289),
- platform reconciler + mutating + validating webhook registration
  (main.go:291-331),
- SecurityProfileWatcher restarting the process on TLS change
  (main.go:344-367).
"""

from __future__ import annotations

import argparse
import logging
import os
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

from kubeflow_tpu_torch.controller.platform import PlatformConfig, PlatformReconciler
from kubeflow_tpu_torch.controller.tls import (
    SecurityProfileWatcher,
    TLSProfile,
    fetch_tls_profile,
)
from kubeflow_tpu_torch.k8s.cache import TransformingClient
from kubeflow_tpu_torch.k8s.client import Client
from kubeflow_tpu_torch.k8s.health import HealthChecks, HealthServer, ping
from kubeflow_tpu_torch.k8s.leader import PLATFORM_LEASE, LeaderElector
from kubeflow_tpu_torch.k8s.manager import FakeClock, Manager, RealClock
from kubeflow_tpu_torch.k8s.serve import install_signal_handlers, serve, split_addr
from kubeflow_tpu_torch.webhook.mutating import NotebookMutatingWebhook, WebhookConfig
from kubeflow_tpu_torch.webhook.validating import NotebookValidatingWebhook

IN_CLUSTER_NAMESPACE_FILE = "/var/run/secrets/kubernetes.io/serviceaccount/namespace"


class FlagError(ValueError):
    """Invalid CLI flags (the reference exits 1 — main.go:172-176)."""


@dataclass
class Options:
    kube_rbac_proxy_image: str = ""
    metrics_addr: str = ":8080"
    probe_addr: str = ":8081"
    webhook_port: int = 8443
    cert_dir: str = ""
    enable_leader_election: bool = False


def parse_args(argv: Optional[list[str]] = None) -> Options:
    parser = argparse.ArgumentParser(prog="platform-notebook-controller")
    parser.add_argument("--kube-rbac-proxy-image", default="")
    parser.add_argument("--metrics-addr", default=":8080")
    parser.add_argument("--probe-addr", default=":8081")
    parser.add_argument("--webhook-port", type=int, default=8443)
    parser.add_argument("--cert-dir", default="")
    parser.add_argument("--enable-leader-election", action="store_true")
    ns = parser.parse_args(argv or [])
    opts = Options(
        kube_rbac_proxy_image=ns.kube_rbac_proxy_image,
        metrics_addr=ns.metrics_addr,
        probe_addr=ns.probe_addr,
        webhook_port=ns.webhook_port,
        cert_dir=ns.cert_dir,
        enable_leader_election=ns.enable_leader_election,
    )
    # Reference main.go:172-176: the image flag is mandatory — fail fast at
    # boot rather than inject an empty sidecar image later.
    if not opts.kube_rbac_proxy_image:
        raise FlagError("--kube-rbac-proxy-image is required")
    return opts


def detect_namespace(env: dict, namespace_file: Optional[str] = None) -> str:
    """Controller-namespace detection (reference main.go:127-139):
    explicit env wins, then the in-cluster serviceaccount namespace file,
    then the development default."""
    if env.get("K8S_NAMESPACE"):
        return env["K8S_NAMESPACE"]
    path = Path(namespace_file or IN_CLUSTER_NAMESPACE_FILE)
    try:
        text = path.read_text().strip()
        if text:
            return text
    except OSError:
        pass
    return "opendatahub"


@dataclass
class PlatformBundle:
    manager: Manager
    options: Options
    health: HealthChecks
    platform_reconciler: PlatformReconciler
    mutating_webhook: NotebookMutatingWebhook
    validating_webhook: NotebookValidatingWebhook
    tls_profile: TLSProfile
    tls_watcher: SecurityProfileWatcher
    cache_client: TransformingClient
    elector: Optional[LeaderElector] = None
    restart_requested: list = field(default_factory=list)

    def run_until_idle(self, max_cycles: int = 200) -> int:
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
    namespace_file: Optional[str] = None,
    identity: str = "platform-controller-0",
    on_tls_change: Optional[Callable[[TLSProfile], None]] = None,
) -> PlatformBundle:
    env = env or {}
    opts = parse_args(argv if argv is not None else ["--kube-rbac-proxy-image", "x"])

    namespace = detect_namespace(env, namespace_file)
    env = {**env, "K8S_NAMESPACE": namespace}

    manager = Manager(cluster, clock)

    # TLS profile at boot + restart-on-change watcher.
    tls_profile = fetch_tls_profile(cluster)
    restart_requested: list = []

    def _restart(profile: TLSProfile) -> None:
        restart_requested.append(profile)
        if on_tls_change:
            on_tls_change(profile)

    tls_watcher = SecurityProfileWatcher(cluster, tls_profile, _restart)
    tls_watcher.register(manager)

    # Informer-cache transform client (used for bulk reads; the reconciler
    # keeps the raw client for payload-bearing objects, as the reference's
    # transform allowlist does).
    cache_client = TransformingClient(cluster)

    platform_cfg = PlatformConfig.from_env(env)
    platform = PlatformReconciler(cluster, config=platform_cfg)
    platform.register(manager)

    webhook_cfg = WebhookConfig.from_env(
        {**env, "KUBE_RBAC_PROXY_IMAGE": opts.kube_rbac_proxy_image}
    )
    mutating = NotebookMutatingWebhook(cluster, config=webhook_cfg)
    validating = NotebookValidatingWebhook(cluster)
    if hasattr(cluster, "register_mutating_webhook"):
        # In-process admission chain (FakeCluster / envtest tier). Against
        # a real apiserver, admission arrives over HTTPS instead — main()
        # serves the same handler objects via WebhookServer.
        mutating.register(cluster)
        validating.register(cluster)

    health = HealthChecks()
    health.add_healthz_check("healthz", ping)
    health.add_readyz_check("readyz", ping)

    elector = None
    if opts.enable_leader_election:
        elector = LeaderElector(
            cluster, PLATFORM_LEASE, namespace, identity, clock=manager.clock
        )

    return PlatformBundle(
        manager=manager,
        options=opts,
        health=health,
        platform_reconciler=platform,
        mutating_webhook=mutating,
        validating_webhook=validating,
        tls_profile=tls_profile,
        tls_watcher=tls_watcher,
        cache_client=cache_client,
        elector=elector,
        restart_requested=restart_requested,
    )


def main(argv: Optional[list[str]] = None) -> int:
    """Process entrypoint (reference odh main.go:141-374): real apiserver
    client, TLS profile at boot, manager + HTTPS admission server, probes,
    run until SIGTERM — or until the cluster TLS profile changes, which
    exits 0 so the pod restarts with the new profile (main.go:344-367)."""
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )
    from kubeflow_tpu_torch.k8s.real import ClusterConfig, RealClient
    from kubeflow_tpu_torch.webhook.server import WebhookServer

    import sys

    if argv is None:
        argv = sys.argv[1:]
    env = dict(os.environ)
    opts = parse_args(argv)
    client = RealClient(ClusterConfig.from_env(env))

    stop = threading.Event()
    bundle = build(
        client,
        env=env,
        argv=argv,
        clock=RealClock(),
        identity=env.get("HOSTNAME", "platform-controller-0"),
        on_tls_change=lambda profile: stop.set(),
    )

    host, port = split_addr(opts.probe_addr)
    health_server = HealthServer(bundle.health, host=host, port=port)
    health_server.start()

    webhook_server = WebhookServer(
        mutating_handler=bundle.mutating_webhook.handle,
        validating_handler=bundle.validating_webhook.handle,
        host="0.0.0.0",
        port=opts.webhook_port,
        cert_dir=opts.cert_dir or None,
        tls_profile=bundle.tls_profile,
    )
    webhook_server.start()
    logging.getLogger(__name__).info(
        "platform-controller up: probes on %s:%d, webhooks on :%d (%s)",
        host, health_server.port, webhook_server.port,
        "https" if webhook_server.tls_enabled else "http",
    )

    metrics_server = None
    if opts.metrics_addr and opts.metrics_addr != "0":
        from kubeflow_tpu_torch.metrics.metrics import Metrics
        from kubeflow_tpu_torch.metrics.server import MetricsServer

        mhost, mport = split_addr(opts.metrics_addr)
        metrics_server = MetricsServer(Metrics(client), host=mhost, port=mport)
        metrics_server.start()

    install_signal_handlers(stop)
    try:
        serve(bundle, client, stop)
    finally:
        health_server.stop()
        webhook_server.stop()
        if metrics_server is not None:
            metrics_server.stop()
        client.stop()
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess e2e
    raise SystemExit(main())
