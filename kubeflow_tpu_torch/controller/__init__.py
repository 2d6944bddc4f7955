"""The Notebook controller on GPU nodes: the spec generators and the
reconcile loop (``notebook.py``), its create-or-update helpers
(``reconcilehelper.py``), the warm SlicePool (``slicepool.py``), the idle
culler (``culling.py``) and its native prober (``prober.py``), slice-health
recovery (``preemption.py``), the image pre-puller (``prepull.py``), and
the platform reconciler (``platform.py``) over routes, network policies,
auth, integrations and the cluster's TLS profile (``tls.py``).
Counterpart of ``kubeflow_tpu/controller``."""

from kubeflow_tpu_torch.controller.notebook import (  # noqa: F401
    ControllerConfig,
    NotebookReconciler,
)
from kubeflow_tpu_torch.controller.culling import (  # noqa: F401
    CullerConfig,
    CullingReconciler,
)
from kubeflow_tpu_torch.controller.preemption import (  # noqa: F401
    SliceHealthReconciler,
)
from kubeflow_tpu_torch.controller.platform import (  # noqa: F401
    PlatformConfig,
    PlatformReconciler,
)
