"""Command-line drivers of the port: ``python -m
resolution_pde_tpu_torch.cli.main_2d`` (and ``main_1d``) train and
evaluate; ``autoregressive_eval`` and ``frequency_evaluation`` evaluate a
checkpoint; all take hydra-style overrides."""
