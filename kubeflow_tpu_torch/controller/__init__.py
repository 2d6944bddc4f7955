"""The Notebook controller on GPU nodes: the spec generators and the
reconcile loop (``notebook.py``), its create-or-update helpers
(``reconcilehelper.py``), the warm SlicePool (``slicepool.py``), the idle
culler (``culling.py``) and its native prober (``prober.py``).
Counterpart of ``kubeflow_tpu/controller``."""
