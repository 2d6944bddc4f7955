"""Admission of a Notebook on GPU nodes, the port's counterpart of
``kubeflow_tpu/webhook``: the mutating webhook (``mutating.py``) with its
device env and annotation projections (``gpu_env.py``), the mounts
(``mounts.py``), the kube-rbac-proxy sidecar (``auth_sidecar.py``) and
update blocking (``diff.py``); the validating webhook
(``validating.py``); and the AdmissionReview server (``server.py``)."""

from kubeflow_tpu_torch.webhook.mutating import NotebookMutatingWebhook, WebhookConfig  # noqa: F401
from kubeflow_tpu_torch.webhook.validating import NotebookValidatingWebhook  # noqa: F401
