"""Validating admission webhook.

The port's counterpart of ``kubeflow_tpu/webhook/validating.py``, over
``spec.gpu`` where JAX's reads ``spec.tpu``. It extends the reference's
validator (reference components/odh-notebook-controller/controllers/
notebook_validating_webhook.go: 31-100 — denies MLflow-annotation removal
on running notebooks) with the slice invariants:

- a ``spec.gpu`` change on a RUNNING slice is denied (the slice would
  have to be torn down; the user must stop the notebook first),
- a ``spec.gpu`` that does not resolve is denied at admission, before
  any object lands (better UX than an event after the fact); that
  includes a ``runtimeVersion`` and a notebook carrying both blocks,
  which ``Notebook.gpu`` refuses.
"""

from __future__ import annotations

from typing import Optional

from kubeflow_tpu_torch.api import annotations as ann
from kubeflow_tpu_torch.api.notebook import Notebook
from kubeflow_tpu_torch.gpu.topology import InvalidTopologyError
from kubeflow_tpu_torch.k8s.client import Client
from kubeflow_tpu_torch.k8s.errors import WebhookDeniedError
from kubeflow_tpu_torch.k8s.fake import AdmissionRequest


class NotebookValidatingWebhook:
    def __init__(self, client: Optional[Client] = None):
        self.client = client

    def register(self, cluster) -> None:
        cluster.register_validating_webhook("Notebook", self.handle)

    def handle(self, req: AdmissionRequest) -> None:
        nb = Notebook(req.object)

        try:
            gpu = nb.gpu
            if gpu is not None:
                gpu.slice_topology()
        except InvalidTopologyError as err:
            raise WebhookDeniedError(f"invalid spec.gpu: {err}") from None

        quant = nb.annotations.get(ann.TPU_QUANTIZATION)
        if quant and quant not in ann.TPU_QUANTIZATION_VALUES:
            raise WebhookDeniedError(
                f"annotation {ann.TPU_QUANTIZATION}: unknown value {quant!r} "
                f"(want one of {', '.join(ann.TPU_QUANTIZATION_VALUES)})"
            )

        prof = nb.annotations.get(ann.TPU_PROFILING_PORT)
        if prof is not None:
            why = ann.profiling_port_error(prof)
            if why is not None:
                raise WebhookDeniedError(
                    f"annotation {ann.TPU_PROFILING_PORT}: {why}"
                )

        serving = nb.annotations.get(ann.TPU_SERVING_PORT)
        if serving is not None:
            why = ann.profiling_port_error(serving)  # same port rules
            if why is not None:
                raise WebhookDeniedError(
                    f"annotation {ann.TPU_SERVING_PORT}: {why}"
                )
            if prof is not None and (
                ann.parse_profiling_port(serving)
                == ann.parse_profiling_port(prof)
            ):
                raise WebhookDeniedError(
                    f"annotations {ann.TPU_SERVING_PORT} and "
                    f"{ann.TPU_PROFILING_PORT} claim the same port "
                    f"{serving} — two servers cannot bind it"
                )

        if req.operation != "UPDATE" or req.old_object is None:
            return
        old = Notebook(req.old_object)
        running = not old.stopped

        if running and old.gpu != gpu:
            raise WebhookDeniedError(
                "spec.gpu cannot change while the notebook is running: changing "
                f"{old.gpu} -> {gpu} would tear down the slice. "
                f"Stop the notebook (annotation {ann.STOP!r}) first."
            )

        # Reference rule: MLflow integration cannot be silently detached
        # from a running notebook (validateMLflowAnnotationRemoval :79-100).
        old_mlflow = old.obj.get("metadata", {}).get("annotations", {}).get(
            ann.MLFLOW_INSTANCE
        )
        new_mlflow = req.object.get("metadata", {}).get("annotations", {}).get(
            ann.MLFLOW_INSTANCE
        )
        if running and old_mlflow and not new_mlflow:
            raise WebhookDeniedError(
                f"annotation {ann.MLFLOW_INSTANCE} cannot be removed while the "
                "notebook is running; stop the notebook first"
            )

