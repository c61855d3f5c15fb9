"""Data generation of the port: the Kuramoto-Sivashinsky solver and the
writers of the KS file layouts the data factories read.

Counterpart of resolution_pde_tpu/datagen/ (``ks.py`` and the KS part of
``writers.py``); the NS, Burgers and Darcy generators are not ported yet.
"""

from resolution_pde_tpu_torch.datagen.ks import (
    ks_initial_conditions,
    random_ks_initial_conditions,
    solve_ks,
)
from resolution_pde_tpu_torch.datagen.writers import (
    write_ks_file,
    write_ks_multires_tree,
)

__all__ = [
    "ks_initial_conditions",
    "random_ks_initial_conditions",
    "solve_ks",
    "write_ks_file",
    "write_ks_multires_tree",
]
