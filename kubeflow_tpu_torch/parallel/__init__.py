"""Parallelism over ``torch.distributed``: the device mesh and its
sharding plan (``mesh.py``), the differentiable collectives
(``collectives.py``), sequence-parallel attention (``ring_attention.py``,
``ulysses.py``, ``zigzag_attention.py``) and the pipeline
(``pipeline.py``). Counterpart of ``kubeflow_tpu/parallel``."""

from kubeflow_tpu_torch.parallel.mesh import MeshPlan, make_mesh  # noqa: F401
