"""The mutating admission webhook: every Notebook create/update flows
through here before either controller sees it.

The port's counterpart of ``kubeflow_tpu/webhook/mutating.py``, in its
order, with the device step over ``spec.gpu``. A rebuild of the
reference Handle pipeline (reference components/odh-notebook-controller/
controllers/notebook_mutating_webhook.go: 360-516):

CREATE only:
  1. reconciliation lock injection (InjectReconciliationLock :113-122) —
     the pod must not start before the platform reconciler has produced
     routes/auth/NetPols; the lock is the stop annotation with a sentinel
     value, removed by the platform controller when ready.
CREATE|UPDATE:
  2. image resolution from ImageStreams (:865-972),
  3. **GPU env injection** — ``gpu_env.inject_gpu_env``'s worker env
     under the JAX package's names, the resolved-topology annotation,
     then the quantization, profiling, serving and checkpoint
     projections,
  4. CA bundle mount, runtime-images mount, Elyra secret mount, Feast
     mount/unmount, MLflow env, cluster-proxy env,
  5. auth sidecar inject/remove by annotation,
  6. update-blocking: webhook-caused pod-template drift on a RUNNING
     notebook is reverted and surfaced as an update-pending annotation
     (maybeRestartRunningNotebook :522-581) — a surprise restart forfeits
     a whole slice.

A ``spec.gpu`` that does not resolve is skipped here, as JAX's skips a
bad ``spec.tpu``: the validating webhook denies it.
``gpu_env.mutate_gpu_notebook``, which raises instead, stays for callers
with no validating webhook behind them.
"""

from __future__ import annotations

import copy
import logging
from dataclasses import dataclass
from typing import Optional

from kubeflow_tpu_torch.api import annotations as ann
from kubeflow_tpu_torch.api.notebook import Notebook
from kubeflow_tpu_torch.gpu.topology import InvalidTopologyError
from kubeflow_tpu_torch.k8s import objects as obj_util
from kubeflow_tpu_torch.k8s.client import Client
from kubeflow_tpu_torch.k8s.errors import NotFoundError, WebhookDeniedError
from kubeflow_tpu_torch.k8s.fake import AdmissionRequest
from kubeflow_tpu_torch.observability.tracing import get_tracer
from kubeflow_tpu_torch.webhook import gpu_env, mounts
from kubeflow_tpu_torch.webhook.auth_sidecar import (
    InvalidSidecarResources,
    inject_kube_rbac_proxy,
    remove_kube_rbac_proxy,
)
from kubeflow_tpu_torch.webhook.diff import first_difference
from kubeflow_tpu_torch.webhook.gpu_env import (
    inject_gpu_env,
    remove_env,
    upsert_env,
)

log = logging.getLogger(__name__)

_MLFLOW_ENV_NAMES = {
    "MLFLOW_TRACKING_URI",
    "MLFLOW_K8S_INTEGRATION",
    "MLFLOW_TRACKING_AUTH",
}
_PROXY_ENV_NAMES = {"HTTP_PROXY", "HTTPS_PROXY", "NO_PROXY"}


@dataclass
class WebhookConfig:
    controller_namespace: str = "opendatahub"
    rbac_proxy_image: str = "kube-rbac-proxy:latest"
    cluster_domain: str = "cluster.local"
    set_pipeline_secret: bool = False
    mlflow_enabled: bool = False
    inject_cluster_proxy_env: bool = False
    gateway_url: str = ""

    @classmethod
    def from_env(cls, env: dict) -> "WebhookConfig":
        return cls(
            controller_namespace=env.get("K8S_NAMESPACE", "opendatahub"),
            rbac_proxy_image=env.get("KUBE_RBAC_PROXY_IMAGE", "kube-rbac-proxy:latest"),
            cluster_domain=env.get("CLUSTER_DOMAIN", "cluster.local"),
            set_pipeline_secret=env.get("SET_PIPELINE_SECRET", "false").lower() == "true",
            mlflow_enabled=env.get("MLFLOW_ENABLED", "false").lower() == "true",
            inject_cluster_proxy_env=env.get("INJECT_CLUSTER_PROXY_ENV", "false").lower()
            == "true",
            gateway_url=env.get("GATEWAY_URL", ""),
        )


class NotebookMutatingWebhook:
    def __init__(self, client: Client, config: Optional[WebhookConfig] = None):
        self.client = client
        self.config = config or WebhookConfig()

    def register(self, cluster) -> None:
        cluster.register_mutating_webhook("Notebook", self.handle)

    # ------------------------------------------------------------------
    def handle(self, req: AdmissionRequest) -> dict:
        obj = req.object
        nb = Notebook(obj)
        # Root admission span (reference Handle :368-373: span per admission
        # with notebook/namespace/operation attributes; lazy tracer :74-76).
        with get_tracer("notebook-webhook").start_span(
            "mutate-notebook",
            notebook=nb.name,
            namespace=nb.namespace,
            operation=req.operation,
        ) as span:
            user_template = copy.deepcopy(
                obj.get("spec", {}).get("template", {}).get("spec", {})
            )

            if req.operation == "CREATE":
                self._inject_reconciliation_lock(nb)

            self._resolve_image_from_registry(nb, span)
            self._inject_gpu(nb)
            self._handle_quant_env(nb)
            self._handle_profiling_env(nb)
            self._handle_serving_env(nb)
            self._handle_checkpoint_env(nb)
            mounts.check_and_mount_ca_bundle(nb, self.client)
            mounts.mount_runtime_images(nb, self.client)
            if self.config.set_pipeline_secret:
                mounts.mount_elyra_secret(nb, self.client)
            mounts.sync_feast_mount(nb)
            if self.config.mlflow_enabled:
                self._handle_mlflow_env(nb)

            if nb.annotations.get(ann.INJECT_AUTH) == "true":
                try:
                    inject_kube_rbac_proxy(nb, self.config.rbac_proxy_image)
                except InvalidSidecarResources as err:
                    raise WebhookDeniedError(str(err)) from None
            else:
                remove_kube_rbac_proxy(nb)

            if self.config.inject_cluster_proxy_env:
                self._inject_cluster_proxy_env(nb)

            if req.operation == "UPDATE" and req.old_object is not None:
                # Child span (reference maybeRestartRunningNotebook :526).
                with get_tracer("notebook-webhook").start_span(
                    "maybe-restart-running-notebook", notebook=nb.name
                ):
                    self._maybe_block_running_update(nb, req.old_object, user_template)
            return obj

    # ------------------------------------------------------------------
    def _inject_reconciliation_lock(self, nb: Notebook) -> None:
        """Hold the pod down until the platform reconciler finishes
        (reference :113-122); never overwrite a user stop annotation."""
        if ann.STOP not in nb.annotations:
            nb.annotations[ann.STOP] = ann.RECONCILIATION_LOCK_VALUE

    def _inject_gpu(self, nb: Notebook) -> None:
        try:
            gpu = nb.gpu
            if gpu is None:
                return
            topo = gpu.slice_topology()
        except InvalidTopologyError:
            return  # validating webhook denies; controller reports otherwise
        inject_gpu_env(nb, topo, self.config.cluster_domain)
        obj_util.set_annotation(
            nb.obj, ann.TPU_RESOLVED_TOPOLOGY,
            f"{topo.accelerator_type}/{topo.topology_str}",
        )

    def _handle_quant_env(self, nb: Notebook) -> None:
        """The quantization annotation into the serving env; "bf16",
        absence and unknown values (denied by the validating webhook)
        leave it unset."""
        gpu_env.project_quant_env(nb)

    def _handle_checkpoint_env(self, nb: Notebook) -> None:
        """The checkpoint durability contract (runtime/checkpoint.py):
        every GPU notebook gets KUBEFLOW_TPU_CHECKPOINT_DIR, and a valid
        grace annotation TPU_CHECKPOINT_GRACE_S and the
        terminationGracePeriodSeconds the kubelet waits."""
        if not nb.obj.get("spec", {}).get("gpu"):
            return
        gpu_env.project_checkpoint_env(nb)

    def _handle_profiling_env(self, nb: Notebook) -> None:
        gpu_env.project_port_env(nb, ann.TPU_PROFILING_PORT,
                                 ann.PROFILING_ENV_NAME)

    def _handle_serving_env(self, nb: Notebook) -> None:
        gpu_env.project_port_env(nb, ann.TPU_SERVING_PORT,
                                 ann.SERVING_ENV_NAME)

    def _resolve_image_from_registry(self, nb: Notebook, span=None) -> None:
        """Resolve "imagestream:tag" annotations to a digested image ref
        (reference SetContainerImageFromRegistry :865-972)."""
        selection = nb.annotations.get(ann.LAST_IMAGE_SELECTION, "")
        if ":" not in selection:
            return
        stream_name, tag = selection.rsplit(":", 1)
        namespace = nb.annotations.get(
            ann.WORKBENCH_IMAGE_NAMESPACE, self.config.controller_namespace
        )
        try:
            stream = self.client.get("ImageStream", stream_name, namespace)
        except NotFoundError:
            log.warning(
                "imagestream %s/%s not found for %s", namespace, stream_name, nb.name
            )
            # Span event (reference :912,:961 records imagestream-not-found).
            if span is not None:
                span.add_event(
                    "imagestream-not-found",
                    {"imagestream": f"{namespace}/{stream_name}"},
                )
            return
        image = _image_for_tag(stream, tag)
        if not image:
            return
        container = nb.primary_container()
        if container is not None and container.get("image") != image:
            container["image"] = image

    def _handle_mlflow_env(self, nb: Notebook) -> None:
        """MLflow env injection/removal by annotation (reference
        HandleMLflowEnvVars :287-322; URI from GATEWAY_URL or Gateway CR
        :107-142)."""
        container = nb.primary_container()
        if container is None:
            return
        instance = nb.annotations.get(ann.MLFLOW_INSTANCE)
        if not instance:
            remove_env(container, _MLFLOW_ENV_NAMES)
            return
        base = self.config.gateway_url or self._gateway_hostname()
        if not base:
            return
        upsert_env(
            container,
            [
                {"name": "MLFLOW_TRACKING_URI", "value": f"{base}/mlflow/{instance}"},
                {"name": "MLFLOW_K8S_INTEGRATION", "value": "true"},
                {"name": "MLFLOW_TRACKING_AUTH", "value": "oauth"},
            ],
        )

    def _gateway_hostname(self) -> str:
        try:
            gateway = self.client.get(
                "Gateway", "data-science-gateway", "openshift-ingress"
            )
        except NotFoundError:
            return ""
        for listener in gateway.get("spec", {}).get("listeners", []):
            hostname = listener.get("hostname")
            if hostname:
                return f"https://{hostname}"
        return ""

    def _inject_cluster_proxy_env(self, nb: Notebook) -> None:
        """Cluster-wide egress proxy env (reference :477-490)."""
        try:
            proxy = self.client.get("Proxy", "cluster")
        except NotFoundError:
            return
        spec = proxy.get("spec", {})
        entries = []
        if spec.get("httpProxy"):
            entries.append({"name": "HTTP_PROXY", "value": spec["httpProxy"]})
        if spec.get("httpsProxy"):
            entries.append({"name": "HTTPS_PROXY", "value": spec["httpsProxy"]})
        if spec.get("noProxy"):
            entries.append({"name": "NO_PROXY", "value": spec["noProxy"]})
        if not entries:
            return
        for container in nb.containers:
            upsert_env(container, entries)

    # ------------------------------------------------------------------
    def _maybe_block_running_update(
        self, nb: Notebook, old: dict, user_template: dict
    ) -> None:
        """Revert webhook-caused template drift on a running notebook
        (reference maybeRestartRunningNotebook :522-581).

        User-intended template changes pass through (the user accepted a
        restart); drift introduced by *this webhook's own mutations* (image
        re-resolution, cert rotation, ...) must not bounce a running slice.
        """
        old_template = (
            old.get("spec", {}).get("template", {}).get("spec", {})
        )
        mutated_template = nb.pod_spec
        if nb.stopped:
            # Stopped (or lock-held) notebooks restart on resume anyway;
            # let mutations land and clear any stale pending marker.
            obj_util.remove_annotation(nb.obj, ann.UPDATE_PENDING)
            return
        if mutated_template == old_template:
            obj_util.remove_annotation(nb.obj, ann.UPDATE_PENDING)
            return
        user_changed = user_template != old_template
        # An inject-auth flip is user intent too: the sidecar add/remove it
        # causes must roll out together with the platform reconciler's
        # SA/Service/ConfigMap changes, or the pod template would reference
        # deleted objects after the next restart.
        old_auth = old.get("metadata", {}).get("annotations", {}).get(ann.INJECT_AUTH)
        new_auth = nb.annotations.get(ann.INJECT_AUTH)
        if user_changed or old_auth != new_auth:
            obj_util.remove_annotation(nb.obj, ann.UPDATE_PENDING)
            return
        diff = first_difference(old_template, mutated_template) or "template changed"
        nb.obj["spec"]["template"]["spec"] = copy.deepcopy(old_template)
        obj_util.set_annotation(nb.obj, ann.UPDATE_PENDING, diff)


def _image_for_tag(stream: dict, tag: str) -> str:
    for entry in stream.get("status", {}).get("tags", []):
        if entry.get("tag") == tag:
            items = entry.get("items", [])
            if items:
                return items[0].get("dockerImageReference", "")
    for entry in stream.get("spec", {}).get("tags", []):
        if entry.get("name") == tag:
            return entry.get("from", {}).get("name", "")
    return ""
