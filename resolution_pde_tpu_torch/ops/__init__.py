"""Numerical ops of the port: grids, normalizers, losses, spectral convs,
SSM kernels (``ops.ssm``), and the hand-written CUDA kernels
(``ops.kernels``)."""
