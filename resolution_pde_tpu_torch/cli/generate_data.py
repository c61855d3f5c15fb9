"""Dataset generation from the command line: the Kuramoto-Sivashinsky
files.

    python -m resolution_pde_tpu_torch.cli.generate_data pde=ks \\
        out=data/ks n=512 resolutions=[512,256,128,64,32] n_snapshots=51 \\
        viscosity=0.075 seed=11

Counterpart of resolution_pde_tpu/cli/generate_data.py for ``pde=ks``: the
same options, file layouts and solver settings; the initial conditions
come from a ``torch.Generator`` seeded with ``seed``, so the samples are
not the JAX package's. Writes KS_train_2048.h5, KS_valid.h5 and
KS_test.h5 at the base (largest) resolution and the res_{R}/visc_...
true multi-resolution tree (writing needs h5py). ``generate_ks_arrays``
is the array part, which returns the trajectories instead. The solver
runs on the card unless ``main`` is given ``device="cpu"``. The other
pdes (burgers, ns, active, darcy) are not ported yet.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

NOT_PORTED = ("burgers", "ns", "active", "darcy")


def _parse(argv):
    opts = {"pde": "ks", "out": "data", "n": 64, "resolutions": [128],
            "n_snapshots": 26, "viscosity": None, "seed": 0,
            "splits": (0.8, 0.1, 0.1), "et": 5.0, "lmax": 8}
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
    return opts


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


def write_ks(out, arrays: dict, n_snapshots, et=5.0, lmax=8):
    """The naive files at the base resolution and the true
    multi-resolution tree, split at the same contiguous boundaries."""
    from resolution_pde_tpu_torch.datagen.writers import (
        write_ks_file, write_ks_multires_tree)

    by_res, snap_dt = arrays["by_res"], arrays["snap_dt"]
    n_tr, n_va, n_te = arrays["split_counts"]
    u = by_res[max(by_res)]
    os.makedirs(out, exist_ok=True)
    write_ks_file(os.path.join(out, "KS_train_2048.h5"), u[:n_tr],
                  dt=snap_dt, split="train")
    write_ks_file(os.path.join(out, "KS_valid.h5"), u[n_tr:n_tr + n_va],
                  dt=snap_dt, split="valid")
    write_ks_file(os.path.join(out, "KS_test.h5"),
                  u[n_tr + n_va:n_tr + n_va + n_te], dt=snap_dt,
                  split="test")
    write_ks_multires_tree(out, by_res, viscosity=arrays["visc"],
                           et=float(et), lmax=int(lmax), nte=n_snapshots,
                           nt=n_snapshots, split_counts=(n_tr, n_va, n_te),
                           dt=snap_dt)
    print("wrote KS naive files (KS_train_2048/valid/test) + true-multires "
          f"tree under {out}")


def generate_ks(out, n, resolutions, n_snapshots, seed, viscosity=None,
                splits=(0.8, 0.1, 0.1), et=5.0, lmax=8, device="cuda"):
    arrays = generate_ks_arrays(n, resolutions, n_snapshots, seed,
                                viscosity, splits, et, lmax, device)
    write_ks(out, arrays, n_snapshots, et, lmax)
    return arrays


def main(argv=None, device="cuda"):
    from resolution_pde_tpu_torch.cli.common import require_device

    opts = _parse(list(argv if argv is not None else sys.argv[1:]))
    if opts["pde"] in NOT_PORTED:
        raise NotImplementedError(
            f"generate_data pde={opts['pde']} is not ported: ROADMAP.md "
            "section 1, item 8")
    if opts["pde"] != "ks":
        raise SystemExit(f"unknown pde {opts['pde']!r}; "
                         "one of ks/burgers/ns/active/darcy")
    device = require_device(device, "generate_data")
    return generate_ks(opts["out"], opts["n"], opts["resolutions"],
                       opts["n_snapshots"], opts["seed"], opts["viscosity"],
                       opts["splits"], opts["et"], opts["lmax"], device)


if __name__ == "__main__":
    main()
