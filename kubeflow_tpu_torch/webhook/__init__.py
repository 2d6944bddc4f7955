"""Admission-time mutations of a Notebook on GPU nodes: the runtime env
and the annotation projections (``gpu_env.py``), and the kube-rbac-proxy
sidecar of auth mode (``auth_sidecar.py``). Counterpart of the pure
parts of ``kubeflow_tpu/webhook``."""
