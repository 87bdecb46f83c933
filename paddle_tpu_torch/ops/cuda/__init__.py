"""Hand-written CUDA kernels for Hopper (sm_90a), built from ``csrc/`` at
first use by :mod:`._build` and bound with ctypes. Each kernel's module
holds its wrapper, its plain PyTorch version and a launch counter."""
