"""Command-line drivers of the port: ``python -m
resolution_pde_tpu_torch.cli.main_2d`` (and ``main_1d``) with hydra-style
overrides."""
