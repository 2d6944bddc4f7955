"""GPU node catalog and slice arithmetic (``topology.py``): the
counterpart of ``kubeflow_tpu/tpu``."""

from kubeflow_tpu_torch.gpu.topology import (  # noqa: F401
    ACCELERATORS,
    Accelerator,
    InvalidTopologyError,
    SliceTopology,
    parse_topology,
    resolve_accelerator,
    slice_from_spec,
)
