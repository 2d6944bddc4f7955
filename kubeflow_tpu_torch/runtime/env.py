"""The environment contract the port's runtime reads.

The port's own copy (it imports nothing of the JAX package, not even its
JAX-free modules) of what ``kubeflow_tpu/webhook/tpu_env.py`` and
``kubeflow_tpu/api/annotations.py`` define for the notebook pod:

- the slice identity the webhook and the controller write
  (``TPU_WORKER_ID`` … ``MEGASCALE_SLICE_ID``), read by
  ``runtime.bootstrap.runtime_from_env``;
- the live-migration budgets (``KUBEFLOW_TPU_MIGRATE_*``), read by
  ``runtime.migration.migration_from_env``;
- the profiling port, the checkpoint grace and the checkpoint directory
  the webhook projects from their annotations, with the two parsers
  admission uses, so a value admission would deny is never honoured here.

The names keep their JAX-era spellings: the webhook writes them, and the
port reads the same pod.
"""

from __future__ import annotations

from typing import Optional

TPU_WORKER_ID = "TPU_WORKER_ID"
TPU_WORKER_HOSTNAMES = "TPU_WORKER_HOSTNAMES"
TPU_ACCELERATOR_TYPE = "TPU_ACCELERATOR_TYPE"
TPU_TOPOLOGY = "TPU_TOPOLOGY"
TPU_HOSTS_PER_SLICE = "TPU_HOSTS_PER_SLICE"
JAX_COORDINATOR_ADDRESS = "JAX_COORDINATOR_ADDRESS"
JAX_NUM_PROCESSES = "JAX_NUM_PROCESSES"
MEGASCALE_NUM_SLICES = "MEGASCALE_NUM_SLICES"
MEGASCALE_SLICE_ID = "MEGASCALE_SLICE_ID"

KUBEFLOW_TPU_MIGRATE_ENABLE = "KUBEFLOW_TPU_MIGRATE_ENABLE"
KUBEFLOW_TPU_MIGRATE_SAVE_BUDGET_S = "KUBEFLOW_TPU_MIGRATE_SAVE_BUDGET_S"
KUBEFLOW_TPU_MIGRATE_CLAIM_BUDGET_S = "KUBEFLOW_TPU_MIGRATE_CLAIM_BUDGET_S"
KUBEFLOW_TPU_MIGRATE_RESTORE_BUDGET_S = (
    "KUBEFLOW_TPU_MIGRATE_RESTORE_BUDGET_S")
KUBEFLOW_TPU_MIGRATE_FLIP_BUDGET_S = "KUBEFLOW_TPU_MIGRATE_FLIP_BUDGET_S"
KUBEFLOW_TPU_MIGRATE_FRESH_WITHIN_S = "KUBEFLOW_TPU_MIGRATE_FRESH_WITHIN_S"

# The port a profiler server would listen on (the tpu-profiling-port
# annotation).
PROFILING_ENV_NAME = "KUBEFLOW_TPU_PROFILING_PORT"
# Seconds of termination grace an emergency checkpoint may spend on
# SIGTERM (the tpu-checkpoint-grace-seconds annotation).
CHECKPOINT_GRACE_ENV_NAME = "TPU_CHECKPOINT_GRACE_S"
# Where the checkpoint volume is mounted in the notebook container.
CHECKPOINT_DIR_ENV_NAME = "KUBEFLOW_TPU_CHECKPOINT_DIR"


def parse_profiling_port(value) -> Optional[int]:
    """A port in 1024..65535, else None. ``int()`` rather than
    ``isdigit()``: Unicode digits such as '²' pass ``isdigit()`` but not
    ``int()``."""
    try:
        port = int(str(value).strip())
    except (TypeError, ValueError):
        return None
    return port if 1024 <= port <= 65535 else None


def parse_checkpoint_grace(value) -> Optional[int]:
    """Whole seconds in 1..3600, else None (the ceiling keeps a mistyped
    value from holding a slice's nodes for hours after a delete)."""
    try:
        grace = int(str(value).strip())
    except (TypeError, ValueError):
        return None
    return grace if 1 <= grace <= 3600 else None
