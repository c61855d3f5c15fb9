"""Readers of the Kuramoto-Sivashinsky, PDEBench Burgers, Darcy,
Navier-Stokes, FNO-paper and active-matter files.

Counterpart of resolution_pde_tpu/data/io.py's ``read_ks_h5`` (with
``_ks_group``, ``_ks_pde_key`` and ``split_from_filename``),
``read_pdebench_h5``, ``read_darcy_h5``, ``read_ns``, ``_load_mat``,
``read_fno_burgers_mat``, ``read_fno_darcy_mat`` and
``read_active_matter_h5``:
  - KS HDF5: split groups 'train'/'valid'/'test' (or a single group), the
    data under the key holding 'pde' and '-' (e.g. 'pde_128-256') as
    (b, t, s), optional 'x' and 't' (reference
    dataloaders/ks_naive_markov.py:190-252);
  - PDEBench Burgers HDF5: 'tensor' (n, t, x) and 'x-coordinate'
    (dataloaders/burger_naive_markov.py:144, 170);
  - PDEBench Darcy HDF5: the coefficient 'nu' (n, h, w) and the solution
    'tensor' (n, 1, h, w) or (n, h, w) (dataloaders/darcy_loader.py:40-52);
  - NS: an .h5 file's key 'u' as (b, t, h, w), or (b, h, w, t) when its
    trailing axis is short (a transpose heuristic), or a .mat file's key
    'u' as (b, h, w, t) (reference dataloaders/ns_naive_markov.py:276-315);
  - FNO-paper .mat: Burgers 'a' -> 'u', Darcy 'coeff' -> 'sol'
    (dataloaders/load_data.py:91-101);
  - the Well: group 't0_fields', a (b, t, h, w) array per scalar field.
h5py is imported only to read an HDF5 file (.h5, or a MATLAB v7.3 .mat),
so the module imports where h5py is absent; .mat files up to v7 go
through scipy. ``files_in_memory`` holds arrays under paths that the KS,
Burgers, Darcy and active-matter readers (and ``glob_files``) then find in
place of files."""

from __future__ import annotations

import contextlib
import fnmatch
import glob
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


# arrays standing in for files: {absolute path: the file's arrays}
_IN_MEMORY: dict = {}


@contextlib.contextmanager
def files_in_memory(files: dict):
    """Within the block, the KS, Burgers, Darcy and active-matter readers,
    ``file_exists`` and ``glob_files`` find each entry of ``files`` in
    place of a file at its path: {path: u} for a KS file (the split's
    trajectories (b, t, s)) or a PDEBench Burgers file ('tensor' (n, t,
    x)), {path: {"a": (n, h, w), "u": (n, h, w)}} for a Darcy file,
    {path: {field: (b, t, h, w)}} for a Well file. The factories, and the
    command lines through them, then run on data generated in the same
    process where no HDF5 file can be written (the card's machine has no
    h5py)."""
    held = {os.path.abspath(p): u for p, u in files.items()}
    _IN_MEMORY.update(held)
    try:
        yield
    finally:
        for p in held:
            _IN_MEMORY.pop(p, None)


# the KS path's name for it
ks_files_in_memory = files_in_memory


def file_exists(path: str) -> bool:
    return os.path.abspath(path) in _IN_MEMORY or os.path.exists(path)


def glob_files(pattern: str) -> list:
    """``glob.glob(pattern)`` and the paths held by ``files_in_memory``
    whose folder is the pattern's and whose name matches its last part,
    as absolute paths, sorted."""
    folder, name = os.path.split(os.path.abspath(pattern))
    held = {p for p in _IN_MEMORY
            if os.path.dirname(p) == folder
            and fnmatch.fnmatchcase(os.path.basename(p), name)}
    return sorted(held | {os.path.abspath(p) for p in glob.glob(pattern)})


def read_ks_h5(path: str, split: Optional[str] = None) -> dict:
    """{'u': (b, t, s) float32, 'x': coordinates or None, 't': times or
    None}; ``split`` defaults to the one the file's name says. A path held
    by ``files_in_memory`` reads its array (x and t None)."""
    held = _IN_MEMORY.get(os.path.abspath(path))
    if held is not None:
        return {"u": np.asarray(held, dtype=np.float32), "x": None,
                "t": None}
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


def read_pdebench_h5(path: str) -> dict:
    """{'u': (n, t, x) float32, 'x': the grid or None}. A path held by
    ``files_in_memory`` reads its array (x None)."""
    held = _IN_MEMORY.get(os.path.abspath(path))
    if held is not None:
        return {"u": np.asarray(held, dtype=np.float32), "x": None}
    import h5py

    with h5py.File(path, "r") as f:
        u = np.array(f["tensor"], dtype=np.float32)
        grid = (np.array(f["x-coordinate"], dtype=np.float32)
                if "x-coordinate" in f else None)
    return {"u": u, "x": grid}


def read_darcy_h5(path: str) -> dict:
    """Steady-state Darcy: {'a': the coefficient 'nu' (n, h, w), 'u': the
    solution 'tensor' (n, h, w)}, float32. A path held by
    ``files_in_memory`` reads its arrays."""
    held = _IN_MEMORY.get(os.path.abspath(path))
    if held is not None:
        nu, sol = held["a"], held["u"]
    else:
        import h5py

        with h5py.File(path, "r") as f:
            nu, sol = f["nu"][()], f["tensor"][()]
    nu = np.asarray(nu, dtype=np.float32)
    sol = np.asarray(sol, dtype=np.float32)
    if sol.ndim == 4 and sol.shape[1] == 1:  # (n, 1, h, w) -> (n, h, w)
        sol = sol[:, 0]
    return {"a": nu, "u": sol}


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


def read_fno_burgers_mat(path: str) -> dict:
    """FNO-paper Burgers: the initial condition 'a' -> the solution 'u'."""
    return {"a": _load_mat(path, "a"), "u": _load_mat(path, "u")}


def read_fno_darcy_mat(path: str) -> dict:
    """FNO-paper Darcy: the coefficient 'coeff' -> the solution 'sol'."""
    return {"a": _load_mat(path, "coeff"), "u": _load_mat(path, "sol")}


def read_active_matter_h5(path: str, fields=("concentration",)) -> np.ndarray:
    """The Well's active-matter layout: the requested scalar fields of
    group 't0_fields' (or, without it, of the file's top level), each
    (b, t, h, w), stacked as channels. Returns (b, t, h, w, c) float32. A
    path held by ``files_in_memory`` reads its fields."""
    held = _IN_MEMORY.get(os.path.abspath(path))
    if held is not None:
        chans = [np.asarray(held[name], dtype=np.float32) for name in fields
                 if name in held]
    else:
        import h5py

        with h5py.File(path, "r") as f:
            grp = f["t0_fields"] if "t0_fields" in f else f
            chans = [np.array(grp[name], dtype=np.float32)
                     for name in fields if name in grp]
    if not chans:
        raise KeyError(f"none of {fields} found in {path}")
    return np.stack(chans, axis=-1)
