"""Manager process entrypoints (the reference's two ``main.go`` files):
``python -m kubeflow_tpu_torch.cmd.notebook_manager`` and
``python -m kubeflow_tpu_torch.cmd.platform_manager``."""
