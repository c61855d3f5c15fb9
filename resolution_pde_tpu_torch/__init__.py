"""resolution_pde_tpu_torch: the PyTorch and CUDA port of resolution_pde_tpu
for one NVIDIA H100.

The JAX package ``resolution_pde_tpu`` is the reference; this package never
imports JAX. Its hot ops are kernels written by hand for Hopper
(``csrc/``), each beside a plain PyTorch version that runs on the CPU.

Subpackages:
  ops        -- grids, normalizers, losses, FFT resampling, spectral
                convs, SSM kernels, the CUDA kernels
  models     -- FFNO1D, FFNO2D; the 1D S4 family (S4Model, S4Block, S4D)
  data       -- NS and KS file reading, Markov pairs and windows,
                normalizer fitting, loaders
  datagen    -- the KS solver (ETDRK4) and the KS file writers
  configs    -- the yaml configs and overrides, model and dataset
                instantiation
  evaluation -- super-resolution sweep, rollout, frequency decomposition
  cli        -- main_2d / main_1d, the eval CLIs, generate_data
  deploy     -- ServingEngine (bucketed inference)
  train      -- Trainer, LR schedules, checkpoints
  utils      -- jax_bridge (JAX parameter and gradient trees ->
                state_dicts), metrics (the run tables)
"""

__version__ = "0.1.0"
