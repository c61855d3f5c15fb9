"""Data generation of the port: the Kuramoto-Sivashinsky, Burgers,
Navier-Stokes and Darcy solvers, Gaussian random fields, and the writers
of the file layouts the data factories read.

Counterpart of resolution_pde_tpu/datagen/ (``ks.py``, ``burgers.py``,
``navier_stokes.py``, ``darcy.py``, ``random_fields.py`` and
``writers.py``).
"""

from resolution_pde_tpu_torch.datagen.burgers import solve_burgers
from resolution_pde_tpu_torch.datagen.darcy import (generate_darcy_dataset,
                                                    solve_darcy)
from resolution_pde_tpu_torch.datagen.ks import (
    ks_initial_conditions,
    random_ks_initial_conditions,
    solve_ks,
)
from resolution_pde_tpu_torch.datagen.navier_stokes import (
    generate_ns_dataset,
    navier_stokes_2d,
    ns_forcing,
)
from resolution_pde_tpu_torch.datagen.random_fields import GaussianRF
from resolution_pde_tpu_torch.datagen.writers import (
    write_darcy_file,
    write_ks_file,
    write_ks_multires_tree,
    write_ns_file,
    write_ns_mat,
    write_pdebench_file,
    write_well_file,
)

__all__ = [
    "GaussianRF",
    "generate_darcy_dataset",
    "generate_ns_dataset",
    "ks_initial_conditions",
    "navier_stokes_2d",
    "ns_forcing",
    "random_ks_initial_conditions",
    "solve_burgers",
    "solve_darcy",
    "solve_ks",
    "write_darcy_file",
    "write_ks_file",
    "write_ks_multires_tree",
    "write_ns_file",
    "write_ns_mat",
    "write_pdebench_file",
    "write_well_file",
]
