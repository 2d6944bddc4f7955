"""SlicePool API: warm GPU slice capacity checked out at notebook spawn.

The port's own copy of ``kubeflow_tpu/api/slicepool.py``, over
``spec.gpu``. A SlicePool holds ``warmReplicas`` placeholder slices: each
is a real indexed StatefulSet with the ``nvidia.com/gpu`` resources and
node selector a Notebook slice of the same shape would use (so the node
pool keeps its nodes) running the workbench image with an idle command
(so kubelets keep the image pulled). When a Notebook of that shape scales
up, the controller *claims* a warm slice — deletes the placeholder,
freeing its cards on already-warm nodes for the notebook's pods — and the
pool refills in the background (level-triggered reconcile).

The labels, annotations and demand signals are the JAX package's. Pools
are namespaced; a pool serves Notebooks in its own namespace.
"""

from __future__ import annotations

from typing import Any, Optional

from kubeflow_tpu_torch.api.notebook import GROUP, GPUSpec
from kubeflow_tpu_torch.k8s import objects as obj_util

KIND = "SlicePool"
VERSION = "v1"

# Labels stamped on placeholder StatefulSets; the claim path selects on them.
POOL_LABEL = "slicepools.kubeflow.org/pool"
STATE_LABEL = "slicepools.kubeflow.org/state"
ACCELERATOR_LABEL = "slicepools.kubeflow.org/accelerator"
TOPOLOGY_LABEL = "slicepools.kubeflow.org/topology"
STATE_WARM = "warm"

# Annotation recorded on the Notebook when its slice came from a pool.
CLAIMED_FROM = "notebooks.kubeflow.org/claimed-from-pool"

# Claim fence stamped ON THE PLACEHOLDER StatefulSet by the claim path,
# immediately before the delete, via an optimistic-concurrency update: the
# listed resourceVersion rides the write, so of two claimants racing one
# placeholder exactly one fence lands — the loser gets a Conflict and moves
# to the next candidate (controller.slicepool.ClaimLost). Without it the
# delete itself is check-then-act and both racers can believe they claimed
# the same slice.
CLAIMED_BY = "slicepools.kubeflow.org/claimed-by"

# Demand signals stamped ON THE POOL by the notebook reconciler's claim
# path (autoscaled pools only); the autoscaler keys off them. LAST_* are
# unix seconds (idle detection); MISS_COUNT is a monotonic counter so N
# concurrent misses scale the target by N, not by 1 (a timestamp alone
# collapses simultaneous demand).
LAST_CLAIM = "slicepools.kubeflow.org/last-claim"
LAST_MISS = "slicepools.kubeflow.org/last-miss"
MISS_COUNT = "slicepools.kubeflow.org/miss-count"


class SlicePool:
    """Typed view over a dict-shaped SlicePool object."""

    def __init__(self, obj: dict):
        self.obj = obj

    @property
    def name(self) -> str:
        return obj_util.name_of(self.obj)

    @property
    def namespace(self) -> str:
        return obj_util.namespace_of(self.obj)

    @property
    def gpu(self) -> GPUSpec:
        return GPUSpec.from_dict(self.obj.get("spec", {}).get("gpu", {}))

    @property
    def warm_replicas(self) -> int:
        return int(self.obj.get("spec", {}).get("warmReplicas", 1))

    @property
    def autoscale(self) -> Optional[dict]:
        """{"min", "max", "scaleDownAfterSeconds"} or None (fixed-size
        pool). When set, it REPLACES warmReplicas: the warm target starts
        at min, grows by one per claim-miss (up to max), and decays by one
        per idle scaleDownAfterSeconds (down to min). min=0 makes the pool
        purely demand-driven."""
        spec = self.obj.get("spec", {}).get("autoscale")
        if not spec:
            return None
        lo = int(spec.get("min", 0))
        # min > max is normalized to max = min (a CRD schema cannot express
        # the cross-field constraint; pinning the target above max forever
        # would be worse than honoring the larger bound).
        return {
            "min": lo,
            "max": max(lo, int(spec.get("max", 1))),
            "scaleDownAfterSeconds": int(spec.get("scaleDownAfterSeconds", 600)),
        }

    @property
    def image(self) -> str:
        """Image the placeholders run (and therefore keep pulled on the
        slice nodes). Default to the standard workbench image."""
        return self.obj.get("spec", {}).get("image", "jax-notebook:latest")

    @property
    def status(self) -> dict:
        return self.obj.setdefault("status", {})


def new_slicepool(
    name: str,
    namespace: str,
    gpu: GPUSpec,
    warm_replicas: int = 1,
    image: Optional[str] = None,
) -> dict:
    obj = obj_util.new_object(f"{GROUP}/{VERSION}", KIND, name, namespace)
    spec: dict[str, Any] = {
        "gpu": gpu.to_dict(),
        "warmReplicas": warm_replicas,
    }
    if image:
        spec["image"] = image
    obj["spec"] = spec
    return obj
