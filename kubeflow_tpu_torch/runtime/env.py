"""The environment contract the port's runtime reads.

The port's own copy (it imports nothing of the JAX package, not even its
JAX-free modules) of what ``kubeflow_tpu/webhook/tpu_env.py`` and
``kubeflow_tpu/api/annotations.py`` define for the notebook pod:

- the slice identity the webhook and the controller write
  (``TPU_WORKER_ID`` … ``MEGASCALE_COORDINATOR_ADDRESS``), written by
  ``webhook/gpu_env.py`` and ``controller/notebook.py`` and read by
  ``runtime.bootstrap.runtime_from_env``;
- the live-migration budgets (``KUBEFLOW_TPU_MIGRATE_*``), read by
  ``runtime.migration.migration_from_env``;
- the profiling port, the checkpoint grace and the checkpoint directory
  the webhook projects from their annotations, with the two parsers
  admission uses, so a value admission would deny is never honoured here
  (both defined in ``api/annotations.py`` beside their annotations, and
  imported here).

The names keep their JAX-era spellings: the webhook writes them, and the
port reads the same pod.
"""

from __future__ import annotations

from kubeflow_tpu_torch.api.annotations import (  # noqa: F401
    CHECKPOINT_DIR_ENV_NAME,
    CHECKPOINT_GRACE_ENV_NAME,
    PROFILING_ENV_NAME,
    parse_checkpoint_grace,
    parse_profiling_port,
)

TPU_WORKER_ID = "TPU_WORKER_ID"
TPU_WORKER_HOSTNAMES = "TPU_WORKER_HOSTNAMES"
TPU_ACCELERATOR_TYPE = "TPU_ACCELERATOR_TYPE"
TPU_TOPOLOGY = "TPU_TOPOLOGY"
# The cards of one host and the hosts of the slice, each as "x,y,z": on a
# GPU node the first number counts and the others are 1.
TPU_CHIPS_PER_HOST_BOUNDS = "TPU_CHIPS_PER_HOST_BOUNDS"
TPU_HOST_BOUNDS = "TPU_HOST_BOUNDS"
# Written for TPU nodes only; the GPU webhook removes a stale one.
TPU_RUNTIME_VERSION = "TPU_RUNTIME_VERSION"
TPU_HOSTS_PER_SLICE = "TPU_HOSTS_PER_SLICE"
JAX_COORDINATOR_ADDRESS = "JAX_COORDINATOR_ADDRESS"
JAX_NUM_PROCESSES = "JAX_NUM_PROCESSES"
MEGASCALE_NUM_SLICES = "MEGASCALE_NUM_SLICES"
MEGASCALE_SLICE_ID = "MEGASCALE_SLICE_ID"
MEGASCALE_COORDINATOR_ADDRESS = "MEGASCALE_COORDINATOR_ADDRESS"

KUBEFLOW_TPU_MIGRATE_ENABLE = "KUBEFLOW_TPU_MIGRATE_ENABLE"
KUBEFLOW_TPU_MIGRATE_SAVE_BUDGET_S = "KUBEFLOW_TPU_MIGRATE_SAVE_BUDGET_S"
KUBEFLOW_TPU_MIGRATE_CLAIM_BUDGET_S = "KUBEFLOW_TPU_MIGRATE_CLAIM_BUDGET_S"
KUBEFLOW_TPU_MIGRATE_RESTORE_BUDGET_S = (
    "KUBEFLOW_TPU_MIGRATE_RESTORE_BUDGET_S")
KUBEFLOW_TPU_MIGRATE_FLIP_BUDGET_S = "KUBEFLOW_TPU_MIGRATE_FLIP_BUDGET_S"
KUBEFLOW_TPU_MIGRATE_FRESH_WITHIN_S = "KUBEFLOW_TPU_MIGRATE_FRESH_WITHIN_S"
