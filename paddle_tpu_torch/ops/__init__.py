"""Kernels of the port (``ops/cuda``)."""
