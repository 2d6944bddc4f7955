"""Notebook → StatefulSet and Services on GPU nodes (``notebook.py``):
the pure spec generators of ``kubeflow_tpu/controller``."""
