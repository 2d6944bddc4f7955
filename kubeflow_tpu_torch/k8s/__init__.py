"""The cluster client layer: the port's own copy of the parts of
``kubeflow_tpu/k8s`` the controllers import.

- ``errors.py``, ``objects.py``, ``client.py``: the API's error types,
  object helpers and the ``Client`` protocol with ``retry_on_conflict``;
- ``fake.py``: ``FakeCluster``, the in-memory API server;
- ``events.py``: ``EventRecorder``;
- ``manager.py``: ``Manager``, ``FakeClock``, ``RealClock``, ``Request``
  and ``Result``;
- ``fixtures.py``: ``FakeKubelet``, ``FakePodRunner`` and
  ``add_gpu_node_pool``.
"""

from kubeflow_tpu_torch.k8s.errors import (  # noqa: F401
    ApiError,
    NotFoundError,
    ConflictError,
    AlreadyExistsError,
    InvalidError,
    WebhookDeniedError,
    is_not_found,
    is_conflict,
)
from kubeflow_tpu_torch.k8s.objects import (  # noqa: F401
    name_of,
    namespace_of,
    labels_of,
    annotations_of,
    set_controller_reference,
    owner_uid,
    is_controlled_by,
    matches_labels,
    merge_patch,
)
from kubeflow_tpu_torch.k8s.client import Client, retry_on_conflict  # noqa: F401
from kubeflow_tpu_torch.k8s.fake import FakeCluster, AdmissionRequest  # noqa: F401
from kubeflow_tpu_torch.k8s.manager import (  # noqa: F401
    Manager,
    Reconciler,
    Result,
    FakeClock,
    RealClock,
)
from kubeflow_tpu_torch.k8s.fixtures import (  # noqa: F401
    FakeKubelet,
    FakePodRunner,
    add_gpu_node_pool,
    add_cpu_node,
)
