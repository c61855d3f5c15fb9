"""Readers of the Navier-Stokes vorticity files.

Counterpart of resolution_pde_tpu/data/io.py's ``read_ns`` and
``_load_mat`` (reference dataloaders/ns_naive_markov.py:276-315): an .h5
file's key 'u' as (b, t, h, w), or (b, h, w, t) when its trailing axis is
short (a transpose heuristic), or a .mat file's key 'u' as (b, h, w, t).
h5py is imported only to read an HDF5 file (.h5, or a MATLAB v7.3 .mat),
so the module imports where h5py is absent; .mat files up to v7 go
through scipy.
"""

from __future__ import annotations

import os

import numpy as np


def read_ns(path: str) -> np.ndarray:
    """Vorticity trajectories (b, t, h, w), float32."""
    if os.path.splitext(path)[1].lower() == ".mat":
        u = _load_mat(path, "u")
        return np.transpose(u, (0, 3, 1, 2)).astype(np.float32)
    import h5py

    with h5py.File(path, "r") as f:
        if "u" not in f:
            raise KeyError(f"'u' not found in {path}; keys: {list(f.keys())}")
        u = np.array(f["u"], dtype=np.float32)
    if u.ndim != 4:
        raise ValueError(f"expected 4D NS data, got {u.shape}")
    # (b, h, w, t) heuristic: a short trailing time axis
    if u.shape[-1] < 100 and u.shape[-1] < min(u.shape[1], u.shape[2]):
        u = np.transpose(u, (0, 3, 1, 2))
    return u


def _load_mat(path: str, key: str) -> np.ndarray:
    """A variable of a .mat file: v7 and older through scipy, v7.3 (an
    HDF5 file, column-major) through h5py."""
    from scipy.io import loadmat

    try:
        mat = loadmat(path)
    except NotImplementedError:
        import h5py

        with h5py.File(path, "r") as f:
            return np.array(f[key], dtype=np.float32).T
    if key not in mat:
        raise KeyError(f"{key!r} not in {path}; keys: "
                       f"{[k for k in mat if not k.startswith('__')]}")
    return np.array(mat[key], dtype=np.float32)
