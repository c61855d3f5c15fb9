"""resolution_pde_tpu_torch: the PyTorch and CUDA port of resolution_pde_tpu
for one NVIDIA H100.

The JAX package ``resolution_pde_tpu`` is the reference; this package never
imports JAX. Its hot ops are kernels written by hand for Hopper
(``csrc/``), each beside a plain PyTorch version that runs on the CPU.

Subpackages:
  ops     -- grids, normalizers, losses, spectral convs, the CUDA kernels
  models  -- FFNO2D
  deploy  -- ServingEngine (bucketed inference)
  utils   -- jax_bridge (JAX parameter trees -> state_dicts)
"""

__version__ = "0.1.0"
