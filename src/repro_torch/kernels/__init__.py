"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each wrapper takes the plain version for tensors on the CPU and launches its
CUDA kernel (built from ``csrc/`` at first use) for tensors on a GPU. Nothing
is imported or built when this package is imported.
"""
