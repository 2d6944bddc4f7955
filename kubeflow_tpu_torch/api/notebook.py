"""The Notebook on GPU nodes: a typed view over the object, and the
schema of its ``spec.gpu`` block.

The counterpart of ``kubeflow_tpu/api/notebook.py``'s ``Notebook`` and
``TPUSpec``. A notebook asks for GPU nodes with

    spec:
      template:
        spec: <PodSpec passthrough>
      gpu:
        accelerator: h100 | h100-mega (+aliases)
        topology: "16"       # the card count
        spot: bool
        sliceCount: int      # identical slices of one multislice notebook

``spec.gpu`` has no ``runtimeVersion``: ``spec.tpu``'s names a libtpu,
and a GPU spec that carries one is refused rather than read without it.
A notebook carries ``spec.tpu`` or ``spec.gpu``, never both.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from kubeflow_tpu_torch.api import annotations as ann
from kubeflow_tpu_torch.gpu.topology import (
    ACCELERATORS,
    _ALIASES,
    InvalidTopologyError,
    SliceTopology,
    slice_from_spec,
)

GROUP = "kubeflow.org"  # the API group of Notebook and SlicePool

# StatefulSet names above this length break the pods' hostnames.
MAX_NAME_LENGTH = 52


@dataclass(frozen=True)
class GPUSpec:
    accelerator: str
    topology: str
    spot: bool = False
    # Multislice: N identical slices form one notebook. 1 = one slice.
    slice_count: int = 1

    def slice_topology(self) -> SliceTopology:
        """Resolve and validate; raises InvalidTopologyError on bad input."""
        if self.slice_count < 1:
            raise InvalidTopologyError(
                f"sliceCount must be >= 1, got {self.slice_count}"
            )
        return slice_from_spec(self.accelerator, self.topology)

    @classmethod
    def from_dict(cls, d: dict) -> "GPUSpec":
        if "runtimeVersion" in d:
            raise InvalidTopologyError(
                f"spec.gpu.runtimeVersion={d['runtimeVersion']!r}: a runtime "
                "version names a libtpu, and GPU nodes take none; remove it"
            )
        return cls(
            accelerator=d.get("accelerator", ""),
            topology=d.get("topology", ""),
            spot=bool(d.get("spot", False)),
            slice_count=int(d.get("sliceCount", 1)),
        )

    def to_dict(self) -> dict:
        out: dict = {"accelerator": self.accelerator,
                     "topology": self.topology}
        if self.spot:
            out["spot"] = True
        if self.slice_count != 1:
            out["sliceCount"] = self.slice_count
        return out


class Notebook:
    """Typed view over a dict-shaped Notebook object (shared storage)."""

    def __init__(self, obj: dict):
        self.obj = obj

    # -- metadata ----------------------------------------------------------
    @property
    def name(self) -> str:
        return self.obj.get("metadata", {}).get("name", "")

    @property
    def namespace(self) -> str:
        return self.obj.get("metadata", {}).get("namespace", "")

    @property
    def annotations(self) -> dict:
        return self.obj.setdefault("metadata", {}).setdefault(
            "annotations", {})

    @property
    def labels(self) -> dict:
        return self.obj.setdefault("metadata", {}).setdefault("labels", {})

    # -- spec --------------------------------------------------------------
    @property
    def pod_spec(self) -> dict:
        return (
            self.obj.setdefault("spec", {})
            .setdefault("template", {})
            .setdefault("spec", {})
        )

    @property
    def containers(self) -> list[dict]:
        return self.pod_spec.setdefault("containers", [])

    def primary_container(self) -> Optional[dict]:
        """The notebook container: the one named like the CR, else the
        first."""
        for c in self.containers:
            if c.get("name") == self.name:
                return c
        return self.containers[0] if self.containers else None

    @property
    def gpu(self) -> Optional[GPUSpec]:
        """``spec.gpu``, or None for a notebook without one. Raises
        InvalidTopologyError for a notebook that also carries
        ``spec.tpu``, or a ``spec.gpu.runtimeVersion``."""
        spec = self.obj.get("spec", {})
        d = spec.get("gpu")
        if not d:
            return None
        if spec.get("tpu"):
            raise InvalidTopologyError(
                "spec.tpu and spec.gpu are exclusive: a notebook runs on TPU "
                "nodes or on GPU nodes; remove one of them"
            )
        return GPUSpec.from_dict(d)

    # -- lifecycle annotations --------------------------------------------
    @property
    def stopped(self) -> bool:
        return ann.STOP in self.obj.get("metadata", {}).get("annotations", {})

    @property
    def lock_held(self) -> bool:
        """The stop annotation is the platform reconciler's lock, not a
        user's stop."""
        return (
            self.obj.get("metadata", {}).get("annotations", {}).get(ann.STOP)
            == ann.RECONCILIATION_LOCK_VALUE
        )


def gpu_spec_schema() -> dict:
    """The CRD's OpenAPI schema of ``spec.gpu``: the counterpart of the
    JAX package's ``spec.tpu`` schema, whose accelerator enum and 2-D/3-D
    topology pattern refuse every GPU spec. ``runtimeVersion`` is declared
    only so that the API server does not prune it before the rule below
    refuses it."""
    accelerators = sorted(ACCELERATORS) + sorted(_ALIASES)
    return {
        "type": "object",
        "required": ["accelerator", "topology"],
        "properties": {
            "accelerator": {
                "type": "string",
                "enum": accelerators,
                "description": "GPU node type (canonical name or GKE alias).",
            },
            "topology": {
                "type": "string",
                "pattern": r"^[1-9]\d*$",
                "description": (
                    "Card count: 1, 2, 4 or 8 on one node, or a multiple "
                    "of 8 over several."
                ),
            },
            "runtimeVersion": {"type": "string"},
            "spot": {"type": "boolean"},
            "sliceCount": {
                "type": "integer",
                "minimum": 1,
                "default": 1,
                "description": (
                    "Number of identical slices forming one multislice "
                    "notebook."
                ),
            },
        },
        "x-kubernetes-validations": [
            {
                "rule": "!has(self.runtimeVersion)",
                "message": (
                    "spec.gpu.runtimeVersion names a libtpu; GPU nodes "
                    "take none"
                ),
            }
        ],
    }
