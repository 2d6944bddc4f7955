"""The Notebook's vocabulary on GPU nodes: child-object names and ports
(``names.py``), the annotation keys the outputs read (``annotations.py``)
and a typed view of the Notebook with its ``spec.gpu`` block
(``notebook.py``). Counterpart of ``kubeflow_tpu/api``."""
