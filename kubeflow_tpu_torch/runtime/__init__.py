"""Runtime of the port: bootstrap, crash-safe checkpointing with the
SIGTERM emergency save, and live migration.

A notebook on a GPU node starts with ``rt = bootstrap()`` and then
``install_preemption_handler(ckpt)`` over a ``CheckpointManager`` in
``checkpoint_dir_from_env()``."""

from kubeflow_tpu_torch.runtime.bootstrap import (  # noqa: F401
    SliceRuntime,
    bootstrap,
    checkpoint_dir_from_env,
    install_preemption_handler,
    runtime_from_env,
)
