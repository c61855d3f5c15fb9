"""Hand-written Hopper kernels, each beside its plain PyTorch version.

A wrapper runs the plain version for a tensor on the CPU and launches its
kernel for a CUDA tensor. The sources are in ``resolution_pde_tpu_torch/csrc``
and are built at first use (``_build``).
"""
