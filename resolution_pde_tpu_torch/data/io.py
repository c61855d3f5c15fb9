"""Readers of the Kuramoto-Sivashinsky and Navier-Stokes files.

Counterpart of resolution_pde_tpu/data/io.py's ``read_ks_h5`` (with
``_ks_group``, ``_ks_pde_key`` and ``split_from_filename``), ``read_ns``
and ``_load_mat``:
  - KS HDF5: split groups 'train'/'valid'/'test' (or a single group), the
    data under the key holding 'pde' and '-' (e.g. 'pde_128-256') as
    (b, t, s), optional 'x' and 't' (reference
    dataloaders/ks_naive_markov.py:190-252);
  - NS: an .h5 file's key 'u' as (b, t, h, w), or (b, h, w, t) when its
    trailing axis is short (a transpose heuristic), or a .mat file's key
    'u' as (b, h, w, t) (reference dataloaders/ns_naive_markov.py:276-315).
h5py is imported only to read an HDF5 file (.h5, or a MATLAB v7.3 .mat),
so the module imports where h5py is absent; .mat files up to v7 go
through scipy.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def _ks_group(f, split: str):
    """The split's group of an open KS file: the split by name, the only
    group, or the first whose name says data, pde or train."""
    if split in f:
        return f[split]
    keys = list(f.keys())
    if len(keys) == 1:
        return f[keys[0]]
    for key in keys:
        if key.lower() in ("data", "pde", "train") or "pde" in key.lower():
            return f[key]
    raise ValueError(f"could not find split {split!r}; available: {keys}")


def _ks_pde_key(group) -> str:
    for key in group.keys():
        if "pde" in key.lower() and "-" in key:
            return key
    raise ValueError(f"no PDE data key in {list(group.keys())}")


def split_from_filename(filename: str) -> str:
    """'train', 'valid' or 'test' as the file's name says; 'train' when
    it says none."""
    low = filename.lower()
    for split in ("train", "valid", "test"):
        if split in low:
            return split
    return "train"


def read_ks_h5(path: str, split: Optional[str] = None) -> dict:
    """{'u': (b, t, s) float32, 'x': coordinates or None, 't': times or
    None}; ``split`` defaults to the one the file's name says."""
    import h5py

    if split is None:
        split = split_from_filename(os.path.basename(path))
    with h5py.File(path, "r") as f:
        group = _ks_group(f, split)
        u = np.array(group[_ks_pde_key(group)], dtype=np.float32)
        out = {"u": u, "x": None, "t": None}
        if "x" in group:
            x = np.array(group["x"], dtype=np.float32)
            out["x"] = x[0] if x.ndim == 2 else x
        if "t" in group:
            out["t"] = np.array(group["t"], dtype=np.float32)
    return out


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
