"""Writers of the KS, Burgers, Darcy, NS and Well file layouts the data
factories read.

Counterpart of resolution_pde_tpu/datagen/writers.py's ``write_ks_file``,
``write_ks_multires_tree``, ``write_pdebench_file``, ``write_darcy_file``,
``write_ns_file`` and ``write_well_file``;
``write_ns_mat`` writes the NS data as a .mat file through scipy. h5py is
imported only when an HDF5 file is written, so the module imports where
h5py is absent.
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


def ks_tree_files(base_folder: str, data_by_res: dict,
                  viscosity: float = 0.075, L: float = 64.0, lmax: int = 8,
                  et: float = 5.0, nte: int = 51, nt: int = 51,
                  train_s: int = 2048, split_counts=None) -> dict:
    """The files of the true multi-resolution tree, {path: (u, split)}:
    per resolution R the directory
    res_{R}/visc_{viscosity}_L{L}_lmax{lmax}_et{et}_nte{nte}_nt{nt}/
    (ks_naive_true_multires.py:255-261). With ``split_counts`` (n_train,
    n_valid, n_test) it holds KS_train_{train_s}.h5, KS_valid.h5 and
    KS_test.h5, contiguous slices of R's trajectories (the files the eval
    swap reads); without, everything goes into the train file."""
    files = {}
    for res, u in data_by_res.items():
        d = os.path.join(
            base_folder, f"res_{res}",
            f"visc_{viscosity}_L{L}_lmax{lmax}_et{et}_nte{nte}_nt{nt}")
        if split_counts is None:
            files[os.path.join(d, f"KS_train_{train_s}.h5")] = (u, "train")
            continue
        n_tr, n_va, n_te = split_counts
        files[os.path.join(d, f"KS_train_{train_s}.h5")] = (u[:n_tr],
                                                             "train")
        files[os.path.join(d, "KS_valid.h5")] = (u[n_tr:n_tr + n_va],
                                                 "valid")
        files[os.path.join(d, "KS_test.h5")] = (
            u[n_tr + n_va:n_tr + n_va + n_te], "test")
    return files


def write_ks_multires_tree(base_folder: str, data_by_res: dict,
                           viscosity: float = 0.075, L: float = 64.0,
                           lmax: int = 8, et: float = 5.0, nte: int = 51,
                           nt: int = 51, train_s: int = 2048,
                           split_counts=None, dt: float | None = None):
    """The true multi-resolution tree (``ks_tree_files``) written."""
    for path, (part, split) in ks_tree_files(
            base_folder, data_by_res, viscosity, L, lmax, et, nte, nt,
            train_s, split_counts).items():
        write_ks_file(path, part, L=L, dt=dt, split=split)


def write_pdebench_file(path: str, u: np.ndarray):
    """PDEBench's Burgers layout: 'tensor' (n, t, x) float32 and
    'x-coordinate', the grid of [0, 1) without its endpoint."""
    import h5py

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with h5py.File(path, "w") as f:
        f.create_dataset("tensor", data=np.asarray(u, np.float32))
        f.create_dataset(
            "x-coordinate",
            data=np.linspace(0, 1, u.shape[-1], endpoint=False)
            .astype(np.float32))


def write_darcy_file(path: str, a: np.ndarray, u: np.ndarray):
    """PDEBench's DarcyFlow layout (``read_darcy_h5``): the coefficient
    'nu' (n, h, w) and the solution 'tensor' (n, 1, h, w), float32."""
    import h5py

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with h5py.File(path, "w") as f:
        f.create_dataset("nu", data=np.asarray(a, np.float32))
        f.create_dataset("tensor", data=np.asarray(u, np.float32)[:, None])


def _ns_canonical(u: np.ndarray) -> np.ndarray:
    """NS trajectories as (n, t, h, w): the solver's (n, h, w, t) layout,
    told by its short trailing time axis, is transposed."""
    if u.ndim == 4 and u.shape[-1] < min(u.shape[1], u.shape[2]):
        u = np.transpose(u, (0, 3, 1, 2))
    return u


def write_ns_file(path: str, u: np.ndarray, a: np.ndarray | None = None,
                  t: np.ndarray | None = None):
    """An NS file: 'u' (n, t, h, w) float32, and optionally 'a' (the
    initial vorticity) and 't'. ``u`` may be in the solver's (n, h, w, t)
    layout (the reader's heuristic takes either,
    ns_naive_markov.py:305-315; the canonical one is stored)."""
    import h5py

    u = _ns_canonical(u)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with h5py.File(path, "w") as f:
        f.create_dataset("u", data=u.astype(np.float32))
        if a is not None:
            f.create_dataset("a", data=a.astype(np.float32))
        if t is not None:
            f.create_dataset("t", data=t.astype(np.float32))


def write_ns_mat(path: str, u: np.ndarray, a: np.ndarray | None = None,
                 t: np.ndarray | None = None):
    """The same data as a MATLAB .mat file (scipy; no h5py needed): 'u'
    laid out (n, h, w, t), as the FNO data files and ``read_ns`` have it,
    and optionally 'a' and 't'."""
    from scipy.io import savemat

    u = np.ascontiguousarray(np.transpose(_ns_canonical(u), (0, 2, 3, 1)),
                             dtype=np.float32)
    data = {"u": u}
    if a is not None:
        data["a"] = np.asarray(a, np.float32)
    if t is not None:
        data["t"] = np.asarray(t, np.float32)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    savemat(path, data)


def write_well_file(path: str, fields: dict):
    """The Well's layout (read_active_matter_h5): one group 't0_fields'
    holding each scalar field as (b, t, h, w) float32."""
    import h5py

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with h5py.File(path, "w") as f:
        grp = f.create_group("t0_fields")
        for name, arr in fields.items():
            grp.create_dataset(name, data=np.asarray(arr, np.float32))
