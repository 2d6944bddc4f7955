"""Admission-time mutations of a Notebook on GPU nodes: the runtime env
and the annotation projections (``gpu_env.py``). Counterpart of the pure
parts of ``kubeflow_tpu/webhook``."""
