"""PyTorch + CUDA port of the paged-attention serving system.

A second package beside the JAX reference ``repro``, with the same
subpackage and module names.  It imports neither ``jax`` nor ``repro``.
Its kernels are hand-written CUDA C++ for Hopper (``csrc/``); every
kernel has a plain PyTorch version beside it that runs on the CPU.
"""
