"""PyTorch/CUDA port of the in-notebook serving stack of ``kubeflow_tpu``.

The port mirrors the JAX package's module paths (``models/llama.py``,
``models/paged.py``, ``ops/ragged_attention.py`` ...) so each module's
counterpart is found by name, but it imports nothing from it: no ``jax``,
no ``jaxlib``, no ``ml_dtypes`` and no ``kubeflow_tpu`` module, not even
the ones that use no JAX. What it needs from those it keeps as its own
copy.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``kubeflow_tpu_torch.device.resolve_device``); the Pallas kernels of the
JAX package become CUDA kernels written for Hopper under ``csrc/``, each
with a plain PyTorch version beside its wrapper that the CPU runs.
"""
