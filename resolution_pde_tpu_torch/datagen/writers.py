"""Writers of the KS file layouts the data factories read.

Counterpart of resolution_pde_tpu/datagen/writers.py's ``write_ks_file``
and ``write_ks_multires_tree``. h5py is imported only when a file is
written, so the module imports where h5py is absent.
"""

from __future__ import annotations

import os

import numpy as np


def write_ks_file(path: str, u: np.ndarray, L: float = 64.0,
                  dt: float | None = None, split: str | None = None):
    """A KS file (dataloaders/ks_naive_markov.py:190-252): a split group
    holding ``pde_{t}-{s}`` = u (n, t, s), and x, t, dx, dt. ``split``
    defaults to the one the file's name says ('train' if none)."""
    import h5py

    if split is None:
        name = os.path.basename(path).lower()
        split = next((s for s in ("train", "valid", "test") if s in name),
                     "train")
    n, t, s = u.shape
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with h5py.File(path, "w") as f:
        g = f.create_group(split)
        g.create_dataset(f"pde_{t}-{s}", data=u.astype(np.float32))
        g.create_dataset("x", data=np.linspace(0, L, s, endpoint=False)
                         .astype(np.float32))
        g.create_dataset("t", data=np.arange(t, dtype=np.float32)
                         * (dt if dt else 1.0))
        g.create_dataset("dx", data=np.float32(L / s))
        g.create_dataset("dt", data=np.float32(dt if dt else 1.0))


def write_ks_multires_tree(base_folder: str, data_by_res: dict,
                           viscosity: float = 0.075, L: float = 64.0,
                           lmax: int = 8, et: float = 5.0, nte: int = 51,
                           nt: int = 51, train_s: int = 2048,
                           split_counts=None, dt: float | None = None):
    """The true multi-resolution tree: per resolution R the directory
    res_{R}/visc_{viscosity}_L{L}_lmax{lmax}_et{et}_nte{nte}_nt{nt}/
    (ks_naive_true_multires.py:255-261). With ``split_counts`` (n_train,
    n_valid, n_test) it holds KS_train_{train_s}.h5, KS_valid.h5 and
    KS_test.h5, contiguous slices of R's trajectories (the files the eval
    swap reads); without, everything goes into the train file."""
    for res, u in data_by_res.items():
        d = os.path.join(
            base_folder, f"res_{res}",
            f"visc_{viscosity}_L{L}_lmax{lmax}_et{et}_nte{nte}_nt{nt}")
        os.makedirs(d, exist_ok=True)
        if split_counts is None:
            parts = {f"KS_train_{train_s}.h5": (u, "train")}
        else:
            n_tr, n_va, n_te = split_counts
            parts = {
                f"KS_train_{train_s}.h5": (u[:n_tr], "train"),
                "KS_valid.h5": (u[n_tr:n_tr + n_va], "valid"),
                "KS_test.h5": (u[n_tr + n_va:n_tr + n_va + n_te], "test"),
            }
        for fname, (part, split) in parts.items():
            write_ks_file(os.path.join(d, fname), part, L=L, dt=dt,
                          split=split)
