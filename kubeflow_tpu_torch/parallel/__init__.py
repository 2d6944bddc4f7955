"""Parallelism over ``torch.distributed``: the device mesh and its
sharding plan (``mesh.py``). Counterpart of ``kubeflow_tpu/parallel``;
ring, Ulysses and zigzag attention and the pipeline come with ROADMAP
queue 1 item 13."""

from kubeflow_tpu_torch.parallel.mesh import MeshPlan, make_mesh  # noqa: F401
