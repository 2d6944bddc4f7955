"""The cluster client layer: the port's own copy of ``kubeflow_tpu/k8s``
(all but ``chaos.py``, ``chaos_catalog.py`` and ``schema.py``).

- ``errors.py``, ``objects.py``, ``client.py``: the API's error types,
  object helpers and the ``Client`` protocol with ``retry_on_conflict``;
- ``fake.py``: ``FakeCluster``, the in-memory API server;
- ``events.py``: ``EventRecorder``;
- ``manager.py``: ``Manager``, ``FakeClock``, ``RealClock``, ``Request``
  and ``Result``;
- ``fixtures.py``: ``FakeKubelet``, ``FakePodRunner`` and
  ``add_gpu_node_pool``;
- ``rest.py``, ``real.py``: the REST paths and ``RealClient``, the
  ``Client`` over a live apiserver, with its list-then-watch stream;
- ``envtest.py``: ``EnvtestServer``, the REST dialect served over a
  ``FakeCluster`` (no CRD schema: see its docstring);
- ``cache.py``, ``health.py``, ``leader.py``, ``serve.py``: the managers'
  cache transform, probes, leader election and serve loop.
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
from kubeflow_tpu_torch.k8s.real import ClusterConfig, RealClient  # noqa: F401
from kubeflow_tpu_torch.k8s.envtest import EnvtestServer  # noqa: F401
from kubeflow_tpu_torch.k8s.fixtures import (  # noqa: F401
    FakeKubelet,
    FakePodRunner,
    add_gpu_node_pool,
    add_cpu_node,
)
