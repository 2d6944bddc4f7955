"""GPU node catalog and slice arithmetic.

The counterpart of ``kubeflow_tpu/tpu/topology.py`` for NVIDIA H100 nodes
on GKE. It turns a user's ``spec.gpu: {accelerator, topology}`` into

- card and host counts: how many pods the indexed StatefulSet has, and
  the ``nvidia.com/gpu`` each one requests;
- the node label that schedules them
  (``cloud.google.com/gke-accelerator``);
- the runtime env's slice shape (``TPU_WORKER_HOSTNAMES`` order and the
  host and card bounds).

The names and properties are ``SliceTopology``'s. What differs:

- The topology is one number, the card count: "1", "2", "4" or "8" fit
  one host; a multiple of 8 spans that many hosts of 8 cards.
- The bounds strings stay three-dimensional, as JAX's are: 16 cards are
  ``"8,1,1"`` cards a host over ``"2,1,1"`` hosts.
- ``node_selector()`` returns the accelerator label alone: GPU node pools
  have no counterpart of ``gke-tpu-topology``.
"""

from __future__ import annotations

import dataclasses
import math


class InvalidTopologyError(ValueError):
    """Raised when an accelerator/topology combination is not schedulable."""


@dataclasses.dataclass(frozen=True)
class Accelerator:
    """One GPU node type as GKE offers it."""

    name: str  # canonical short name: h100, h100-mega
    gke_label: str  # value of cloud.google.com/gke-accelerator
    chips_per_host: int  # cards on one node
    # Card counts a pod on one node may request: a multiple of
    # chips_per_host beyond these spans several nodes.
    single_host_chips: tuple[int, ...]
    type_prefix: str  # accelerator-type string prefix
    hbm_gib_per_chip: int  # device memory of one card, GiB

    @property
    def dims(self) -> int:
        """Topology dimensionality: 1, the card count."""
        return 1

    @property
    def max_single_host_chips(self) -> int:
        return max(self.single_host_chips)

    def type_name(self, chips: int) -> str:
        """Accelerator-type string, e.g. ``h100-80gb-16``."""
        return f"{self.type_prefix}-{chips}"


# GKE's H100 node types, both SXM cards with 80 GB of HBM3, 8 to a node:
# A3 High (machine type a3-highgpu-8g) and A3 Mega (a3-megagpu-8g).
ACCELERATORS: dict[str, Accelerator] = {
    "h100": Accelerator("h100", "nvidia-h100-80gb", 8, (1, 2, 4, 8),
                        "h100-80gb", 80),
    "h100-mega": Accelerator("h100-mega", "nvidia-h100-mega-80gb", 8,
                             (1, 2, 4, 8), "h100-mega-80gb", 80),
}

# User-facing aliases accepted in spec.gpu.accelerator: the GKE labels
# and the machine families.
_ALIASES = {
    "nvidia-h100-80gb": "h100",
    "a3-highgpu": "h100",
    "nvidia-h100-mega-80gb": "h100-mega",
    "a3-megagpu": "h100-mega",
}


def resolve_accelerator(name: str) -> Accelerator:
    key = name.strip().lower()
    key = _ALIASES.get(key, key)
    try:
        return ACCELERATORS[key]
    except KeyError:
        raise InvalidTopologyError(
            f"unknown GPU accelerator {name!r}; known: "
            f"{sorted(ACCELERATORS)} (aliases: {sorted(_ALIASES)})"
        ) from None


def parse_topology(topology: str) -> tuple[int, ...]:
    """Parse ``"16"`` into ``(16,)`` (and ``"2x4"`` into ``(2, 4)``, which
    ``slice_from_spec`` then refuses as not one-dimensional)."""
    parts = topology.strip().lower().split("x")
    try:
        dims = tuple(int(p) for p in parts)
    except ValueError:
        raise InvalidTopologyError(
            f"malformed topology string {topology!r}") from None
    if not dims or any(d < 1 for d in dims):
        raise InvalidTopologyError(f"malformed topology string {topology!r}")
    return dims


@dataclasses.dataclass(frozen=True)
class SliceTopology:
    """A resolved GPU slice: node type + card count. ``hosts`` is the
    number of pods in the indexed StatefulSet; ``chips_per_host`` is the
    ``nvidia.com/gpu`` request of each pod."""

    accelerator: Accelerator
    dims: tuple[int, ...]

    # -- basic counts ------------------------------------------------------
    @property
    def chips(self) -> int:
        return math.prod(self.dims)

    @property
    def single_host(self) -> bool:
        return self.chips <= self.accelerator.max_single_host_chips

    @property
    def chips_per_host(self) -> int:
        return self.chips if self.single_host else self.accelerator.chips_per_host

    @property
    def hosts(self) -> int:
        return 1 if self.single_host else self.chips // self.accelerator.chips_per_host

    # -- naming / scheduling metadata -------------------------------------
    @property
    def topology_str(self) -> str:
        return "x".join(str(d) for d in self.dims)

    @property
    def accelerator_type(self) -> str:
        return self.accelerator.type_name(self.chips)

    @property
    def gke_accelerator_label(self) -> str:
        return self.accelerator.gke_label

    def node_selector(self) -> dict[str, str]:
        return {"cloud.google.com/gke-accelerator": self.gke_accelerator_label}

    # -- bounds ------------------------------------------------------------
    def host_shape(self) -> tuple[int, ...]:
        """Cards owned by one host: all of them on one host, else (8,)."""
        if self.single_host:
            return self.dims
        return (self.accelerator.chips_per_host,)

    def host_bounds(self) -> tuple[int, ...]:
        """Host grid of the slice (dims / host_shape)."""
        shape = self.host_shape()
        return tuple(d // s for d, s in zip(self.dims, shape))

    def chip_bounds_str(self) -> str:
        """``TPU_CHIPS_PER_HOST_BOUNDS``-style string, always 3-D."""
        shape = self.host_shape() + (1,) * (3 - len(self.dims))
        return ",".join(str(s) for s in shape)

    def host_bounds_str(self) -> str:
        """``TPU_HOST_BOUNDS``-style string, always 3-D."""
        bounds = self.host_bounds() + (1,) * (3 - len(self.dims))
        return ",".join(str(b) for b in bounds)

    # -- slice DNS ---------------------------------------------------------
    def worker_hostnames(
        self, name: str, headless_service: str, namespace: str,
        cluster_domain: str = "cluster.local",
    ) -> list[str]:
        """Stable per-host DNS names in TPU_WORKER_ID order: pod
        ``{name}-{i}`` of the indexed StatefulSet is worker ``i``, and the
        headless Service gives each a stable FQDN."""
        return [
            f"{name}-{i}.{headless_service}.{namespace}.svc.{cluster_domain}"
            for i in range(self.hosts)
        ]


def slice_from_spec(accelerator: str, topology: str) -> SliceTopology:
    """Validate and resolve a user-provided accelerator/topology pair."""
    acc = resolve_accelerator(accelerator)
    dims = parse_topology(topology)
    if len(dims) != acc.dims:
        raise InvalidTopologyError(
            f"{acc.name} topologies are {acc.dims}-D, got {topology!r}"
        )
    st = SliceTopology(acc, dims)
    if st.single_host:
        if st.chips not in acc.single_host_chips:
            raise InvalidTopologyError(
                f"topology {topology!r} is not a {acc.name} host shape "
                f"(one host takes {', '.join(map(str, acc.single_host_chips))}"
                " cards)"
            )
    else:
        shape = st.host_shape()
        for d, s in zip(dims, shape):
            if d % s != 0:
                raise InvalidTopologyError(
                    f"topology {topology!r} does not tile into {acc.name} hosts "
                    f"(host shape {'x'.join(map(str, shape))})"
                )
    return st
