"""Kernels of the port: CUDA sources under ``csrc/``, wrappers here."""
