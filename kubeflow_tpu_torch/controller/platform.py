"""Platform reconciler: the orchestrator over routes/auth/netpol/integrations.

The port's own copy of ``kubeflow_tpu/controller/platform.py``, a rebuild
of the reference's ODH reconciler (reference
components/odh-notebook-controller/controllers/notebook_controller.go:190-523
and its SetupWithManager watch wiring :736-884):

deletion branch (:207-333)  → legacy OAuthClient, central-ns HTTPRoute,
                              ReferenceGrant-if-last, auth CRB, finalizer off
finalizer add (:335-381)    → with requeue
steady state (:388-523)     → CA bundle CM, NetworkPolicies, runtime-images
                              CM, pipeline RBAC (env-gated), Elyra secret
                              (env-gated), ReferenceGrant, auth bundle OR
                              plain HTTPRoute (+ conflict cleanup), MLflow
                              (requeue 30s until ClusterRole), reconciliation
                              -lock removal — the step that finally lets the
                              slice start.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Optional

from kubeflow_tpu_torch.api import annotations as ann
from kubeflow_tpu_torch.api.notebook import Notebook
from kubeflow_tpu_torch.controller import auth as auth_mod
from kubeflow_tpu_torch.controller import integrations, network, routes
from kubeflow_tpu_torch.k8s.client import Client, retry_on_conflict
from kubeflow_tpu_torch.k8s.errors import NotFoundError
from kubeflow_tpu_torch.k8s.events import EventRecorder
from kubeflow_tpu_torch.k8s.manager import Manager, Reconciler, Request, Result

log = logging.getLogger(__name__)

FINALIZER = ann.PLATFORM_CLEANUP_FINALIZER
# Poll cadence while waiting for the token controller to mint the pod
# ServiceAccount's image-pull secret (reference :155-186 wait step).
PULL_SECRET_REQUEUE_S = 2.0


@dataclass
class PlatformConfig:
    controller_namespace: str = "opendatahub"
    set_pipeline_rbac: bool = False
    set_pipeline_secret: bool = False
    mlflow_enabled: bool = False
    gateway_hostname: str = ""
    routes: routes.RouteConfig = field(default_factory=routes.RouteConfig)

    def __post_init__(self):
        # Single source of truth: the route layer always lives in the same
        # controller namespace as everything else.
        self.routes.controller_namespace = self.controller_namespace

    @classmethod
    def from_env(cls, env: dict) -> "PlatformConfig":
        return cls(
            controller_namespace=env.get("K8S_NAMESPACE", "opendatahub"),
            set_pipeline_rbac=env.get("SET_PIPELINE_RBAC", "false").lower() == "true",
            set_pipeline_secret=env.get("SET_PIPELINE_SECRET", "false").lower()
            == "true",
            mlflow_enabled=env.get("MLFLOW_ENABLED", "false").lower() == "true",
            gateway_hostname=env.get("GATEWAY_URL", "").removeprefix("https://"),
            routes=routes.RouteConfig.from_env(env),
        )


class PlatformReconciler(Reconciler):
    def __init__(
        self,
        client: Client,
        config: Optional[PlatformConfig] = None,
        recorder: Optional[EventRecorder] = None,
    ):
        self.client = client
        self.config = config or PlatformConfig()
        self.recorder = recorder or EventRecorder(client, component="platform")

    def register(self, manager: Manager) -> None:
        manager.register(
            self,
            for_kind="Notebook",
            owns=(
                "ServiceAccount",
                "Service",
                "ConfigMap",
                "Secret",
                "NetworkPolicy",
                "RoleBinding",
            ),
            watches=[
                ("HTTPRoute", _route_to_notebook),
                ("ReferenceGrant", _grant_to_notebooks(self.client)),
            ],
            name="Platform",
        )

    # ------------------------------------------------------------------
    def reconcile(self, req: Request) -> Result:
        try:
            obj = self.client.get("Notebook", req.name, req.namespace)
        except NotFoundError:
            return Result()
        nb = Notebook(obj)

        if "deletionTimestamp" in obj["metadata"]:
            self._handle_deletion(nb)
            return Result()

        # Finalizer add-on-first-sight, with conflict retry (reference
        # :335-381 batches finalizer adds the same way).
        if FINALIZER not in obj["metadata"].get("finalizers", []):
            def add():
                fresh = self.client.get("Notebook", nb.name, nb.namespace)
                fins = fresh["metadata"].setdefault("finalizers", [])
                if FINALIZER not in fins:
                    fins.append(FINALIZER)
                    self.client.update(fresh)

            retry_on_conflict(add)
            return Result(requeue_after=0.0)

        cfg = self.config
        integrations.reconcile_ca_bundle(self.client, nb, cfg.controller_namespace)
        network.reconcile_network_policies(
            self.client, nb, cfg.controller_namespace,
            gateway_namespace=cfg.routes.gateway_namespace,
        )
        integrations.sync_runtime_images_config_map(
            self.client, nb, cfg.controller_namespace
        )
        if cfg.set_pipeline_rbac:
            integrations.reconcile_pipeline_rbac(self.client, nb)
        if cfg.set_pipeline_secret:
            integrations.sync_elyra_runtime_config(
                self.client, nb, cfg.gateway_hostname
            )
        routes.reconcile_reference_grant(self.client, nb, cfg.routes)

        auth_mode = nb.annotations.get(ann.INJECT_AUTH) == "true"
        routes.ensure_conflicting_route_absent(self.client, nb, cfg.routes, auth_mode)
        if auth_mode:
            auth_mod.reconcile_auth_bundle(self.client, nb)
        else:
            auth_mod.cleanup_auth_mode_off(self.client, nb)
        routes.reconcile_httproute(self.client, nb, cfg.routes, auth_mode)

        requeue = 0.0
        if cfg.mlflow_enabled:
            delay = integrations.reconcile_mlflow_rbac(self.client, nb)
            if delay:
                self.recorder.eventf(
                    obj, "Normal", "WaitingForMLflowOperator",
                    f"ClusterRole {integrations.MLFLOW_CLUSTER_ROLE} not found; "
                    "retrying",
                )
                requeue = delay

        if nb.lock_held:
            if not self._pull_secret_ready(nb):
                # The pod would race its registry pull against the
                # token controller minting the SA's pull secret and
                # land in ImagePullBackOff; hold the lock and requeue
                # (reference RemoveReconciliationLock :155-186 waits on
                # the same secret before releasing).
                self.recorder.eventf(
                    nb.obj, "Normal", "WaitingForPullSecret",
                    "ServiceAccount image-pull secret not yet minted; "
                    "holding reconciliation lock",
                )
                return Result(requeue_after=PULL_SECRET_REQUEUE_S)
            self._remove_reconciliation_lock(nb)
        return Result(requeue_after=requeue)

    # ------------------------------------------------------------------
    def _pull_secret_ready(self, nb: Notebook) -> bool:
        """True once the pod's ServiceAccount exists AND carries an
        imagePullSecrets entry. The pod runs as the template's
        serviceAccountName when set (the auth webhook injects one), else
        the namespace "default" SA."""
        sa_name = nb.pod_spec.get("serviceAccountName") or "default"
        try:
            sa = self.client.get("ServiceAccount", sa_name, nb.namespace)
        except NotFoundError:
            return False
        return bool(sa.get("imagePullSecrets"))

    def _remove_reconciliation_lock(self, nb: Notebook) -> None:
        """Everything is in place — release the lock so the slice starts
        (reference RemoveReconciliationLock :155-186, the merge-patch that
        removes the stop annotation)."""

        def release():
            fresh = self.client.get("Notebook", nb.name, nb.namespace)
            anns = fresh.get("metadata", {}).get("annotations", {})
            if anns.get(ann.STOP) == ann.RECONCILIATION_LOCK_VALUE:
                del anns[ann.STOP]
                self.client.update(fresh)

        retry_on_conflict(release)

    def _handle_deletion(self, nb: Notebook) -> None:
        """Reference deletion branch (:207-333), in the same order."""
        if FINALIZER not in nb.obj["metadata"].get("finalizers", []):
            return
        integrations.cleanup_legacy_oauth_client(self.client, nb)
        routes.delete_httproute(self.client, nb, self.config.routes)
        routes.delete_reference_grant_if_last_notebook(
            self.client, nb, self.config.routes
        )
        auth_mod.cleanup_auth_bundle(self.client, nb)

        def remove_finalizer():
            fresh = self.client.get("Notebook", nb.name, nb.namespace)
            fins = fresh["metadata"].get("finalizers", [])
            if FINALIZER in fins:
                fins.remove(FINALIZER)
                self.client.update(fresh)

        retry_on_conflict(remove_finalizer)


# ---------------------------------------------------------------------------
# Watch map functions (reference SetupWithManager :736-884)


def _route_to_notebook(ev) -> list[Request]:
    """Central-ns HTTPRoutes map back to their notebook by labels."""
    labels = ev.object.get("metadata", {}).get("labels", {})
    name = labels.get(routes.NOTEBOOK_NAME_ROUTE_LABEL)
    namespace = labels.get(routes.NOTEBOOK_NS_LABEL)
    if name and namespace:
        return [Request(name, namespace)]
    return []


def _grant_to_notebooks(client: Client):
    """A ReferenceGrant event re-reconciles every notebook in its namespace."""

    def map_fn(ev) -> list[Request]:
        out = []
        for nb in client.list("Notebook", ev.namespace):
            out.append(Request(nb["metadata"]["name"], ev.namespace))
        return out

    return map_fn
