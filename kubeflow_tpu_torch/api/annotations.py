"""The annotation keys and labels the GPU-node outputs and the controller
loop read, with the env names they project into and the parsers admission
uses.

The port's copy of the parts of ``kubeflow_tpu/api/annotations.py`` that
the StatefulSet, the Services, the webhook's env projections, the
reconciler, the culler, the slice-health and pre-pull reconcilers, the
platform reconciler and the auth sidecar read.
Keys, labels and env names keep their JAX spellings
(``notebooks.kubeflow.org/tpu-*``): the same Notebook objects carry them
whichever package renders the pod.
"""

from __future__ import annotations

from typing import Optional

# -- lifecycle: controller-owned, never copied onto pod templates ------------
STOP = "kubeflow-resource-stopped"  # present: the slice is scaled to 0
# The stop annotation's value while the platform reconciler holds the
# notebook back (its routes, policies and pull secret not yet in place).
RECONCILIATION_LOCK_VALUE = "odh-notebook-controller-lock"
RESTART = "notebooks.opendatahub.io/notebook-restart"
UPDATE_PENDING = "notebooks.opendatahub.io/update-pending"
LAST_ACTIVITY = "notebooks.kubeflow.org/last-activity"
LAST_ACTIVITY_CHECK = "notebooks.kubeflow.org/last_activity_check_timestamp"
TPU_SLICE_INTERRUPTED = "notebooks.kubeflow.org/tpu-slice-interrupted"
TPU_RECOVERY_STARTED = "notebooks.kubeflow.org/tpu-recovery-started"
TPU_RECOVERY_ESCALATIONS = "notebooks.kubeflow.org/tpu-recovery-escalations"
TPU_RECOVERY_LAST_ESCALATION = (
    "notebooks.kubeflow.org/tpu-recovery-last-escalation")
TPU_LAST_INTERRUPTION_DURATION = (
    "notebooks.kubeflow.org/tpu-last-interruption-duration")
# Operator-set migration trigger: any value asks the slice-health
# reconciler to fire its migration hook once; it clears the annotation
# when it picks the trigger up.
TPU_MIGRATE_NOW = "notebooks.kubeflow.org/tpu-migrate-now"

# Event re-emission cursor: the token of the newest pod Event already
# surfaced onto this Notebook (one read a reconcile, no write to Events,
# and it survives a controller restart because it lives on the Notebook).
LAST_SEEN_EVENT_RV = "notebooks.kubeflow.org/last-seen-event-rv"

# -- auth and the platform's integrations ------------------------------------
INJECT_AUTH = "notebooks.opendatahub.io/inject-auth"
INJECT_OAUTH_LEGACY = "notebooks.opendatahub.io/inject-oauth"
AUTH_SIDECAR_CPU_REQUEST = "notebooks.opendatahub.io/auth-sidecar-cpu-request"
AUTH_SIDECAR_CPU_LIMIT = "notebooks.opendatahub.io/auth-sidecar-cpu-limit"
AUTH_SIDECAR_MEMORY_REQUEST = (
    "notebooks.opendatahub.io/auth-sidecar-memory-request")
AUTH_SIDECAR_MEMORY_LIMIT = (
    "notebooks.opendatahub.io/auth-sidecar-memory-limit")
LAST_IMAGE_SELECTION = "notebooks.opendatahub.io/last-image-selection"
WORKBENCH_IMAGE_NAMESPACE = (
    "notebooks.opendatahub.io/workbench-image-namespace")
MLFLOW_INSTANCE = "opendatahub.io/mlflow-instance"
FEAST_INTEGRATION_LABEL = "opendatahub.io/feast-integration"
# Runtime-image sync: ImageStreams with this label become the user
# namespace's pipeline runtime images.
RUNTIME_IMAGE_LABEL = "opendatahub.io/runtime-image"
RUNTIME_IMAGE_NAME = "opendatahub.io/runtime-image-name"

# Istio routing overrides of the VirtualService (USE_ISTIO).
REWRITE_URI = "notebooks.kubeflow.org/http-rewrite-uri"
HEADERS_REQUEST_SET = "notebooks.kubeflow.org/http-headers-request-set"

# The webhook records the resolved slice shape here.
TPU_RESOLVED_TOPOLOGY = "notebooks.kubeflow.org/tpu-resolved-topology"

# -- runtime options the webhook projects into the pod's env ------------------
# Serving quantization: "int8" | "int4" | "fp8" | "bf16" (bf16 and absence
# both leave the env unset).
TPU_QUANTIZATION = "notebooks.kubeflow.org/tpu-quantization"
TPU_QUANTIZATION_VALUES = ("int8", "int4", "fp8", "bf16")
QUANT_ENV_NAME = "KUBEFLOW_TPU_QUANT"
# The port a profiler server would listen on.
TPU_PROFILING_PORT = "notebooks.kubeflow.org/tpu-profiling-port"
PROFILING_ENV_NAME = "KUBEFLOW_TPU_PROFILING_PORT"
# The in-notebook HTTP inference endpoint's port.
TPU_SERVING_PORT = "notebooks.kubeflow.org/tpu-serving-port"
SERVING_ENV_NAME = "KUBEFLOW_TPU_SERVING_PORT"
# Seconds of termination grace an emergency checkpoint may spend on
# SIGTERM: projected into the env and into the pod's
# terminationGracePeriodSeconds.
TPU_CHECKPOINT_GRACE = "notebooks.kubeflow.org/tpu-checkpoint-grace-seconds"
CHECKPOINT_GRACE_ENV_NAME = "TPU_CHECKPOINT_GRACE_S"
# Where the checkpoint volume is mounted in the notebook container.
TPU_CHECKPOINT_DIR = "notebooks.kubeflow.org/tpu-checkpoint-dir"
CHECKPOINT_DIR_ENV_NAME = "KUBEFLOW_TPU_CHECKPOINT_DIR"
DEFAULT_CHECKPOINT_DIR = "/mnt/checkpoints"

# -- controller-owned markers ------------------------------------------------
# Marks the image pre-pull pods (controller/prepull.py).
PREPULL_LABEL = "notebooks.kubeflow.org/prepull"
# The platform reconciler's finalizer: the Notebook's deletion waits for
# its teardown of the routes, the grant and the auth binding.
PLATFORM_CLEANUP_FINALIZER = "notebooks.kubeflow.org/platform-cleanup"

# -- labels ------------------------------------------------------------------
NOTEBOOK_NAME_LABEL = "notebook-name"
ODH_DASHBOARD_LABEL = "opendatahub.io/dashboard"


def _reserved_ports() -> dict:
    from kubeflow_tpu_torch.api import names

    return {
        names.NOTEBOOK_PORT: "the notebook server",
        names.RBAC_PROXY_PORT: "the kube-rbac-proxy sidecar",
        names.JAX_COORDINATOR_PORT: "the torch.distributed rendezvous",
        names.MEGASCALE_PORT: "the multislice coordinator",
    }


# Ports already taken inside a notebook pod: a profiling or serving port
# on one of these would collide at bootstrap.
RESERVED_POD_PORTS = _reserved_ports()


def profiling_port_error(value) -> Optional[str]:
    """Why a port annotation's ``value`` is denied at admission, or None:
    outside 1024..65535, or one of ``RESERVED_POD_PORTS``. The reserved
    ports gate admission only; ``parse_profiling_port`` keeps reading a
    value admitted before."""
    port = parse_profiling_port(value)
    if port is None:
        return f"{value!r} is not a port in 1024..65535"
    if port in RESERVED_POD_PORTS:
        return f"port {port} is already used in-pod by {RESERVED_POD_PORTS[port]}"
    return None


def parse_profiling_port(value) -> Optional[int]:
    """The one parser for a port annotation or env value: a port in
    1024..65535, else None. ``int()`` rather than ``isdigit()``: Unicode
    digits such as '²' pass ``isdigit()`` but not ``int()``."""
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
