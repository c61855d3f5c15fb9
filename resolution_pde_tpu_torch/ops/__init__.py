"""Numerical ops of the port: grids, normalizers, losses, spectral convs,
and the hand-written CUDA kernels (``ops.kernels``)."""
