"""Dataset generation from the command line: the Kuramoto-Sivashinsky,
Burgers, Navier-Stokes, active-matter and Darcy files.

    python -m resolution_pde_tpu_torch.cli.generate_data pde=ks \\
        out=data/ks n=512 resolutions=[512,256,128,64,32] n_snapshots=51 \\
        viscosity=0.075 seed=11
    python -m resolution_pde_tpu_torch.cli.generate_data pde=burgers \\
        out=data/burgers n=512 resolutions=[1024] n_snapshots=51 \\
        viscosity=0.001 seed=12
    python -m resolution_pde_tpu_torch.cli.generate_data pde=ns \\
        out=data/ns n=128 resolutions=[256] n_snapshots=26 \\
        viscosity=1e-03 seed=13 [format=mat]
    python -m resolution_pde_tpu_torch.cli.generate_data pde=darcy \\
        out=data/darcy n=256 resolutions=[128]

Counterpart of resolution_pde_tpu/cli/generate_data.py: the same
options, file layouts and solver settings; the initial conditions and
coefficients come from a ``torch.Generator`` seeded with ``seed``, so the
samples are not the JAX package's. Writes, per pde:
  ks:      KS_train_2048.h5, KS_valid.h5 and KS_test.h5 at the base
           (largest) resolution and the res_{R}/visc_... true
           multi-resolution tree;
  burgers: 1D_Burgers_Sols_Nu{nu}.hdf5 (PDEBench's layout) at the base
           resolution and burgers_{res}_{nu}/1D_Burgers_Sols_Nu{nu}.hdf5
           per resolution (solved at that grid);
  ns:      ns_{res}_{viscosity}.h5 per resolution (solved at that grid),
           or with ``format=mat`` the same data as .mat files (scipy),
           which the NS factories read where h5py is absent;
  active:  active_matter_{i}.hdf5, NS trajectories in the Well's layout
           over ``n_files`` files (a stand-in for the active-matter data);
  darcy:   darcy_flow_beta_{beta}_{res}.hdf5 per resolution (``viscosity``
           is PDEBench's beta, default 0.01; no time axis), and the base
           resolution's again as darcy_flow_beta_{beta}.hdf5 and
           darcy_flow.h5, the names the reference's and the shipped yaml
           read.
HDF5 files need h5py. The ``generate_*_arrays`` functions are the array
parts, which return the data instead; ``ks_in_memory``,
``burgers_in_memory``, ``darcy_in_memory`` and ``active_in_memory`` hold
them under the paths the files would have (``data.io.files_in_memory``), so the factories and
the command lines read them where h5py is absent. The solvers run on the
card unless ``main`` is given ``device="cpu"``.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

def _parse(argv):
    opts = {"pde": "ks", "out": "data", "n": 64, "resolutions": [128],
            "n_snapshots": 26, "viscosity": None, "seed": 0,
            "splits": (0.8, 0.1, 0.1), "et": 5.0, "lmax": 8,
            "format": "h5"}
    given = set()
    for a in argv:
        if "=" not in a:
            raise SystemExit(f"expected key=value, got {a!r}")
        k, v = a.split("=", 1)
        if k not in opts:
            raise SystemExit(
                f"unknown option {k!r}; one of {sorted(opts)}")
        given.add(k)
        if k in ("n", "n_snapshots", "seed", "lmax"):
            opts[k] = int(v)
        elif k == "et":
            opts[k] = float(v)
        elif k == "resolutions":
            opts[k] = [int(r) for r in v.strip("[]").split(",")]
        elif k == "splits":
            parts = tuple(float(r) for r in v.strip("[]()").split(","))
            if len(parts) != 3:
                raise SystemExit("splits needs 3 fractions, e.g. "
                                 "splits=[0.8,0.1,0.1]")
            opts[k] = parts
        else:
            opts[k] = v
    ks_only = given & {"splits", "et", "lmax"}
    if ks_only and opts["pde"] != "ks":
        raise SystemExit(f"option(s) {sorted(ks_only)} only apply to "
                         f"pde=ks, not pde={opts['pde']}")
    if "format" in given and opts["pde"] != "ns":
        raise SystemExit(f"option 'format' only applies to pde=ns, not "
                         f"pde={opts['pde']}")
    if opts["format"] not in ("h5", "mat"):
        raise SystemExit(f"format={opts['format']!r}: one of h5, mat")
    return opts


def _grf_ics(generator, n, res, dim, alpha, tau, device):
    """``n`` Gaussian random fields at ``res`` (JAX generate_data's
    initial conditions), drawn from ``generator``, on ``device``."""
    from resolution_pde_tpu_torch.datagen.random_fields import GaussianRF

    return GaussianRF(dim=dim, size=res, alpha=alpha,
                      tau=tau).sample(generator, n, device)


def split_counts(n: int, splits=(0.8, 0.1, 0.1)) -> tuple:
    """(n_train, n_valid, n_test): at least one trajectory each."""
    n_va = max(1, int(splits[1] * n))
    n_te = max(1, int(splits[2] * n))
    return max(1, n - n_va - n_te), n_va, n_te


def generate_ks_arrays(n, resolutions, n_snapshots, seed, viscosity=None,
                       splits=(0.8, 0.1, 0.1), et=5.0, lmax=8,
                       device="cuda") -> dict:
    """KS trajectories at each resolution, solved at that grid when it
    resolves the dissipation range, else at a finer one and spectrally
    truncated. Returns {"by_res": {res: (n, n_snapshots, res) float32},
    "split_counts", "snap_dt" (the actual snapshot spacing), "visc"}."""
    from resolution_pde_tpu_torch.data.transforms import resize_trajectories
    from resolution_pde_tpu_torch.datagen.ks import (ks_initial_conditions,
                                                     random_ks_draws,
                                                     solve_ks)

    visc = float(viscosity) if viscosity else 1.0
    L = 64.0
    gen = torch.Generator().manual_seed(int(seed))
    base = max(resolutions)
    # a grid resolves KS when its dealiased band reaches twice the linear
    # balance wavenumber 1 / sqrt(visc): res >= 3 L / (pi sqrt(visc))
    res_min = int(np.ceil(3.0 * L / (np.pi * np.sqrt(visc)))) + 1
    # the resolved amplitude scales as 1 / sqrt(visc); 3x headroom over
    # standard KS's max|u| ~ 3 flags a runaway long before NaN
    amp_bound = 10.0 / np.sqrt(min(1.0, visc))
    # a fixed step in standard KS units (dt / visc = 0.05); snapshots every
    # et / (n_snapshots - 1), rounded to a multiple of the step
    dt = 0.05 * min(1.0, visc)
    interval = float(et) / max(n_snapshots - 1, 1)
    spb = max(1, int(round(interval / dt)))
    by_res = {}
    for res in sorted(resolutions, reverse=True):
        # one draw a resolution: a retry at a finer grid solves the same
        # continuous initial condition
        amps, phases = (a.to(device)
                        for a in random_ks_draws(gen, n, int(lmax)))
        solve_res = res
        if res < res_min:
            solve_res = max(base, 1 << int(np.ceil(np.log2(res_min))))
            print(f"ks res {res}: under-resolved for visc={visc} "
                  f"(needs res >= {res_min}); solving at {solve_res} "
                  f"and spectrally truncating")
        while True:
            u0 = ks_initial_conditions(amps, phases, solve_res, L=L)
            traj = solve_ks(u0, L=L, visc=visc, dt=dt,
                            n_snapshots=n_snapshots,
                            steps_per_snapshot=spb).cpu().numpy()
            peak = (float(np.abs(traj).max()) if np.isfinite(traj).all()
                    else float("inf"))
            # a runaway is growth: past the resolved bound and 1.5x the
            # initial condition's own peak (the sum of sines may exceed
            # the bound by itself)
            bound = max(amp_bound, 1.5 * float(np.abs(traj[:, 0]).max()))
            if peak <= bound:
                break
            if solve_res >= 8192:
                raise RuntimeError(
                    f"KS solve diverged even at {solve_res} "
                    f"(max|u|={peak:.1f} > {bound:.1f})")
            print(f"ks res {res}: solve at {solve_res} ran away "
                  f"(max|u|={peak:.1f} > bound {bound:.1f}); "
                  f"retrying at {solve_res * 2}")
            solve_res *= 2
        if solve_res != res:
            traj = resize_trajectories(traj, res, spatial_ndim=1,
                                       method="downsample")
        by_res[res] = np.ascontiguousarray(traj, dtype=np.float32)
        print(f"ks res {res}: {by_res[res].shape} "
              f"max|u|={np.abs(by_res[res]).max():.2f}")
    return {"by_res": by_res, "split_counts": split_counts(n, splits),
            "snap_dt": spb * dt, "visc": visc}


def ks_files(out, arrays: dict, n_snapshots, et=5.0, lmax=8) -> dict:
    """The KS files ``generate_ks`` writes, {path: (u, split)}: the naive
    files at the base resolution and the true multi-resolution tree,
    split at the same contiguous boundaries."""
    from resolution_pde_tpu_torch.datagen.writers import ks_tree_files

    by_res = arrays["by_res"]
    n_tr, n_va, n_te = arrays["split_counts"]
    u = by_res[max(by_res)]
    files = {
        os.path.join(out, "KS_train_2048.h5"): (u[:n_tr], "train"),
        os.path.join(out, "KS_valid.h5"): (u[n_tr:n_tr + n_va], "valid"),
        os.path.join(out, "KS_test.h5"): (u[n_tr + n_va:n_tr + n_va + n_te],
                                          "test"),
    }
    files.update(ks_tree_files(
        out, by_res, viscosity=arrays["visc"], et=float(et), lmax=int(lmax),
        nte=n_snapshots, nt=n_snapshots, split_counts=(n_tr, n_va, n_te)))
    return files


def ks_in_memory(out, arrays: dict, n_snapshots, et=5.0, lmax=8):
    """A context within which the KS factories read ``ks_files`` from
    memory (``data.io.ks_files_in_memory``) instead of from files: the
    command lines run on generated trajectories without h5py."""
    from resolution_pde_tpu_torch.data.io import files_in_memory

    return files_in_memory({
        path: u for path, (u, _) in ks_files(out, arrays, n_snapshots, et,
                                             lmax).items()})


def write_ks(out, arrays: dict, n_snapshots, et=5.0, lmax=8):
    """``ks_files`` written (h5py), with the actual snapshot spacing as
    their dt."""
    from resolution_pde_tpu_torch.datagen.writers import write_ks_file

    for path, (u, split) in ks_files(out, arrays, n_snapshots, et,
                                     lmax).items():
        write_ks_file(path, u, dt=arrays["snap_dt"], split=split)
    print("wrote KS naive files (KS_train_2048/valid/test) + true-multires "
          f"tree under {out}")


def generate_ks(out, n, resolutions, n_snapshots, seed, viscosity=None,
                splits=(0.8, 0.1, 0.1), et=5.0, lmax=8, device="cuda"):
    arrays = generate_ks_arrays(n, resolutions, n_snapshots, seed,
                                viscosity, splits, et, lmax, device)
    write_ks(out, arrays, n_snapshots, et, lmax)
    return arrays


def generate_burgers_arrays(n, resolutions, n_snapshots, seed,
                            viscosity=None, device="cuda") -> dict:
    """Burgers trajectories solved at each resolution from GRF (alpha 2.5,
    tau 7) initial conditions: 100 steps of dt 1e-4 a snapshot. Returns
    {"by_res": {res: (n, n_snapshots, res) float32}, "nu": the viscosity
    as the file names write it}."""
    from resolution_pde_tpu_torch.datagen.burgers import solve_burgers

    nu = float(viscosity) if viscosity else 0.001
    gen = torch.Generator().manual_seed(int(seed))
    by_res = {}
    for res in sorted(resolutions, reverse=True):
        u0 = _grf_ics(gen, n, res, dim=1, alpha=2.5, tau=7.0, device=device)
        by_res[res] = solve_burgers(u0, nu=nu, dt=1e-4,
                                    n_snapshots=n_snapshots,
                                    steps_per_snapshot=100).cpu().numpy()
        print(f"burgers res {res}: {by_res[res].shape}", flush=True)
    return {"by_res": by_res, "nu": nu}


def burgers_files(out, arrays: dict) -> dict:
    """The files ``generate_burgers`` writes, {path: u (n, t, res)}: the
    PDEBench file at the base resolution and one per resolution in
    burgers_{res}_{nu}/ (the true multi-resolution folders)."""
    by_res, nu = arrays["by_res"], arrays["nu"]
    name = f"1D_Burgers_Sols_Nu{nu}.hdf5"
    files = {os.path.join(out, name): by_res[max(by_res)]}
    for res, u in by_res.items():
        files[os.path.join(out, f"burgers_{res}_{nu}", name)] = u
    return files


def burgers_in_memory(out, arrays: dict):
    """A context within which the Burgers factories read ``burgers_files``
    from memory instead of from files."""
    from resolution_pde_tpu_torch.data.io import files_in_memory

    return files_in_memory(burgers_files(out, arrays))


def write_burgers(out, arrays: dict):
    """``burgers_files`` written (h5py)."""
    from resolution_pde_tpu_torch.datagen.writers import write_pdebench_file

    for path, u in burgers_files(out, arrays).items():
        write_pdebench_file(path, u)
    print(f"wrote PDEBench file + burgers_<res>_<nu>/ dirs under {out}")


def generate_burgers(out, n, resolutions, n_snapshots, seed, viscosity=None,
                     device="cuda"):
    arrays = generate_burgers_arrays(n, resolutions, n_snapshots, seed,
                                     viscosity, device)
    write_burgers(out, arrays)
    return arrays


def generate_darcy_arrays(n, resolutions, seed, viscosity=None,
                          device="cuda") -> dict:
    """Darcy coefficients and solutions at each resolution (GRF alpha 2,
    tau 3 thresholded to 12 and 3; the CG solve gated on its residual).
    Returns {"by_res": {res: {"a": (n, res, res), "u": (n, res, res)}},
    "beta": beta as the file names write it, "cg": {res: each batch's
    iterations and largest residual}}."""
    from resolution_pde_tpu_torch.datagen.darcy import generate_darcy_dataset

    beta = viscosity or "0.01"
    gen = torch.Generator().manual_seed(int(seed))
    by_res, cg = {}, {}
    for res in sorted(resolutions, reverse=True):
        info = []
        a, u = generate_darcy_dataset(gen, n, s=res, beta=float(beta),
                                      device=device, info=info)
        by_res[res] = {"a": a, "u": u}
        cg[res] = [(r["iterations"], float(r["residuals"].max()))
                   for r in info]
        print(f"darcy res {res}: a {a.shape}, u in [{u.min():.2e}, "
              f"{u.max():.2e}], CG (iterations, largest residual) a batch "
              f"{cg[res]}", flush=True)
    return {"by_res": by_res, "beta": beta, "cg": cg}


def darcy_files(out, arrays: dict) -> dict:
    """The files ``generate_darcy`` writes, {path: {"a", "u"}}: one per
    resolution, and the base resolution's again under the names the
    reference's yaml (darcy_flow_beta_{beta}.hdf5) and the shipped one
    (darcy_flow.h5) read."""
    by_res, beta = arrays["by_res"], arrays["beta"]
    files = {os.path.join(out, f"darcy_flow_beta_{beta}_{res}.hdf5"): d
             for res, d in by_res.items()}
    for name in (f"darcy_flow_beta_{beta}.hdf5", "darcy_flow.h5"):
        files[os.path.join(out, name)] = by_res[max(by_res)]
    return files


def darcy_in_memory(out, arrays: dict):
    """A context within which the Darcy factory reads ``darcy_files`` from
    memory instead of from files."""
    from resolution_pde_tpu_torch.data.io import files_in_memory

    return files_in_memory(darcy_files(out, arrays))


def write_darcy(out, arrays: dict):
    """``darcy_files`` written (h5py)."""
    from resolution_pde_tpu_torch.datagen.writers import write_darcy_file

    for path, d in darcy_files(out, arrays).items():
        write_darcy_file(path, d["a"], d["u"])
    print(f"wrote darcy_flow_beta_{arrays['beta']}[_res].hdf5 (+ "
          f"darcy_flow.h5 alias) under {out}")


def generate_darcy(out, n, resolutions, n_snapshots, seed, viscosity=None,
                   device="cuda"):
    """``n_snapshots`` is ignored: Darcy is steady."""
    arrays = generate_darcy_arrays(n, resolutions, seed, viscosity, device)
    write_darcy(out, arrays)
    return arrays


def _ns_trajectories(w0, res, visc, n_snapshots):
    """The NS solve of ``generate_ns``: the whole batch at once, snapshots
    every 0.1 time units (dt 1e-3) under the reference's forcing. Returns
    (u (n, n_snapshots, res, res) float32 numpy, sol_t)."""
    from resolution_pde_tpu_torch.datagen.navier_stokes import (
        navier_stokes_2d, ns_forcing)

    sol, sol_t = navier_stokes_2d(w0, ns_forcing(res), visc=visc,
                                  T=float(n_snapshots) * 0.1, delta_t=1e-3,
                                  record_steps=n_snapshots)
    return sol.permute(0, 3, 1, 2).contiguous().cpu().numpy(), sol_t


def generate_ns_arrays(n, resolutions, n_snapshots, seed, viscosity=None,
                       device="cuda") -> dict:
    """NS vorticity trajectories solved at each resolution from GRF
    (alpha 2.5, tau 7) initial conditions, all n in one batch. Returns
    {"by_res": {res: (n, n_snapshots, res, res) float32}, "t": the
    snapshot times, "visc": the viscosity as the file names write it}."""
    visc_str = viscosity or "1e-3"
    visc = float(visc_str)
    gen = torch.Generator().manual_seed(int(seed))
    by_res, sol_t = {}, None
    for res in sorted(resolutions, reverse=True):
        w0 = _grf_ics(gen, n, res, dim=2, alpha=2.5, tau=7.0, device=device)
        by_res[res], sol_t = _ns_trajectories(w0, res, visc, n_snapshots)
        print(f"ns res {res}: {by_res[res].shape}", flush=True)
    return {"by_res": by_res, "t": sol_t, "visc": visc_str}


def write_ns(out, arrays: dict, file_format="h5") -> list:
    """ns_{res}_{visc}.h5 (or .mat) per resolution under ``out``; returns
    the paths."""
    from resolution_pde_tpu_torch.datagen.writers import (write_ns_file,
                                                          write_ns_mat)

    write = write_ns_file if file_format == "h5" else write_ns_mat
    paths = []
    for res, u in arrays["by_res"].items():
        paths.append(os.path.join(
            out, f"ns_{res}_{arrays['visc']}.{file_format}"))
        write(paths[-1], u)
    print(f"wrote ns_<res>_{arrays['visc']}.{file_format} files under {out}")
    return paths


def generate_ns(out, n, resolutions, n_snapshots, seed, viscosity=None,
                device="cuda", file_format="h5"):
    arrays = generate_ns_arrays(n, resolutions, n_snapshots, seed,
                                viscosity, device)
    write_ns(out, arrays, file_format)
    return arrays


def generate_active_arrays(n, resolutions, n_snapshots, seed,
                           viscosity=None, n_files=4,
                           device="cuda") -> list:
    """The Well's active-matter stand-in for the ns_active_t* datasets:
    NS vorticity trajectories at the largest resolution in place of the
    concentration field (the layout is exact, the physics a stand-in: the
    Well's data is not in the repository), ``n`` split over ``n_files``
    files, the first files one larger where it does not divide. Returns
    one (size, n_snapshots, res, res) float32 array a file."""
    visc = float(viscosity) if viscosity else 1e-3
    gen = torch.Generator().manual_seed(int(seed))
    res = max(resolutions)
    per_file, rem = divmod(n, n_files)
    sizes = [per_file + (1 if i < rem else 0) for i in range(n_files)]
    arrays = []
    for size in sizes:
        if size == 0:
            continue
        w0 = _grf_ics(gen, size, res, dim=2, alpha=2.5, tau=7.0,
                      device=device)
        arrays.append(_ns_trajectories(w0, res, visc, n_snapshots)[0])
    return arrays


def active_files(out, arrays: list) -> dict:
    """The files ``generate_active`` writes, {active_matter_{i}.hdf5:
    {"concentration": (b, t, h, w)}}."""
    return {os.path.join(out, f"active_matter_{i}.hdf5"): {"concentration": u}
            for i, u in enumerate(arrays)}


def active_in_memory(out, arrays: list):
    """A context within which the active-matter factories read
    ``active_files`` from memory instead of from files (their glob
    included)."""
    from resolution_pde_tpu_torch.data.io import files_in_memory

    return files_in_memory(active_files(out, arrays))


def write_active(out, arrays: list) -> list:
    """``active_files`` written in the Well's layout (h5py); returns the
    paths."""
    from resolution_pde_tpu_torch.datagen.writers import write_well_file

    files = active_files(out, arrays)
    for path, fields in files.items():
        write_well_file(path, fields)
    print(f"wrote {len(files)} active_matter_*.hdf5 files under {out}")
    return list(files)


def generate_active(out, n, resolutions, n_snapshots, seed, viscosity=None,
                    n_files=4, device="cuda"):
    arrays = generate_active_arrays(n, resolutions, n_snapshots, seed,
                                    viscosity, n_files, device)
    return write_active(out, arrays)


def main(argv=None, device="cuda"):
    from resolution_pde_tpu_torch.cli.common import require_device

    opts = _parse(list(argv if argv is not None else sys.argv[1:]))
    gen = {"ks": generate_ks, "burgers": generate_burgers,
           "ns": generate_ns, "active": generate_active,
           "darcy": generate_darcy}.get(opts["pde"])
    if gen is None:
        raise SystemExit(f"unknown pde {opts['pde']!r}; "
                         "one of ks/burgers/ns/active/darcy")
    device = require_device(device, "generate_data")
    extra = {"ks": {"splits": opts["splits"], "et": opts["et"],
                    "lmax": opts["lmax"]},
             "ns": {"file_format": opts["format"]}}.get(opts["pde"], {})
    return gen(opts["out"], opts["n"], opts["resolutions"],
               opts["n_snapshots"], opts["seed"], opts["viscosity"],
               device=device, **extra)


if __name__ == "__main__":
    main()
