"""Prometheus metrics without ``prometheus_client``: the registry
(``registry.py``), the bundle of families (``metrics.py``) and the
``/metrics`` endpoint (``server.py``). Counterpart of
``kubeflow_tpu/metrics``."""

from kubeflow_tpu_torch.metrics.metrics import Metrics  # noqa: F401
