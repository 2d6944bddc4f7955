"""Runnable entry points of the port (``python -m kubeflow_tpu_torch.examples.<name>``)."""
