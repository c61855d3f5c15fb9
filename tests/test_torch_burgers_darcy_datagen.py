"""The port's Burgers and Darcy generators against the JAX package's: the
Burgers solver from one numpy initial condition (64 and 48 points, three
snapshots of 100 steps; relative L2 1e-5), the Darcy operator on the same
coefficients and field (1e-6), the CG solution (16² and 24², relative L2
1e-4) with each sample stopped as when solved alone, an unconverged solve
refused by both, ``generate_darcy_dataset``'s coefficients and their
solutions, and ``generate_data pde=burgers`` and ``pde=darcy``: the files
the port writes, read back by JAX's readers to the arrays the array parts
return, laid out where JAX's command writes them.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
h5py = pytest.importorskip("h5py")
import jax.numpy as jnp  # noqa: E402

from resolution_pde_tpu.data import io as jio  # noqa: E402
from resolution_pde_tpu.datagen import burgers as jburgers  # noqa: E402
from resolution_pde_tpu.datagen import darcy as jdarcy  # noqa: E402
from resolution_pde_tpu_torch.cli import generate_data as tgen  # noqa: E402
from resolution_pde_tpu_torch.datagen import darcy as tdarcy  # noqa: E402
from resolution_pde_tpu_torch.datagen import (  # noqa: E402
    generate_darcy_dataset, solve_burgers, solve_darcy)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _coeffs(n, s, seed):
    rng = np.random.default_rng(seed)
    return np.where(rng.standard_normal((n, s, s)) > 0.3, 12.0,
                    3.0).astype(np.float32)


@pytest.mark.parametrize("n", [64, 48])
def test_solve_burgers_matches_jax(n):
    rng = np.random.default_rng(n)
    x = np.arange(n) / n
    u0 = (np.sin(2 * np.pi * (x[None] + rng.random((3, 1))))
          + 0.5 * np.cos(4 * np.pi * x[None])).astype(np.float32)
    want = jburgers.solve_burgers(jnp.asarray(u0), nu=1e-3, dt=1e-4,
                                  n_snapshots=3, steps_per_snapshot=100)
    got = solve_burgers(torch.from_numpy(u0), nu=1e-3, dt=1e-4,
                        n_snapshots=3, steps_per_snapshot=100)
    assert got.shape == (3, 3, n) and got.dtype == torch.float32
    np.testing.assert_array_equal(got[:, 0].numpy(), u0)
    assert _rel(got, want) < 1e-5
    # the solution moved: the check is not of the initial condition alone
    assert _rel(got[:, -1], got[:, 0]) > 1e-2


def test_darcy_operator_matches_jax():
    a = _coeffs(3, 12, 0)
    u = np.random.default_rng(1).standard_normal((3, 12, 12)).astype(
        np.float32)
    want = jax.vmap(jdarcy._apply_operator)(jnp.asarray(a), jnp.asarray(u))
    got = tdarcy._apply_operator(torch.from_numpy(a), torch.from_numpy(u))
    assert _rel(got, want) < 1e-6


@pytest.mark.parametrize("s", [16, 24])
def test_darcy_cg_matches_jax(s):
    a = _coeffs(4, s, s)
    want = jdarcy.solve_darcy(jnp.asarray(a), beta=1.0)
    info = {}
    got = solve_darcy(torch.from_numpy(a), beta=1.0, info=info)
    assert got.shape == (4, s, s)
    assert _rel(got, want) < 1e-4
    assert 0 < info["iterations"] < 40 * s and info["residuals"].max() < 1e-4
    # each sample stops on its own: solved alone it comes out the same
    for i in (0, 3):
        alone = solve_darcy(torch.from_numpy(a[i:i + 1]), beta=1.0)
        np.testing.assert_allclose(alone[0].numpy(), got[i].numpy(),
                                   rtol=1e-6, atol=1e-9)


def test_unconverged_darcy_solve_raises():
    a = _coeffs(2, 16, 5)
    with pytest.raises(RuntimeError, match="failed to converge"):
        solve_darcy(torch.from_numpy(a), maxiter=3)
    with pytest.raises(RuntimeError, match="failed to converge"):
        jdarcy.solve_darcy(jnp.asarray(a), maxiter=3)


def test_generate_darcy_dataset():
    info = []
    a, u = generate_darcy_dataset(torch.Generator().manual_seed(0), 5, s=16,
                                  beta=0.01, batch_size=3, info=info)
    assert a.shape == u.shape == (5, 16, 16) and a.dtype == np.float32
    assert set(np.unique(a)) == {3.0, 12.0}
    assert len(info) == 2 and max(r["residuals"].max() for r in info) < 1e-2
    # positive pressure under a positive source and zero walls
    assert np.isfinite(u).all() and u.min() > 0
    want = jdarcy.solve_darcy(jnp.asarray(a), beta=0.01)
    assert _rel(u, want) < 1e-4


def test_generate_data_burgers_writes_what_jax_reads(tmp_path):
    out = tmp_path / "burgers"
    tgen.main(["pde=burgers", f"out={out}", "n=3", "resolutions=[32,16]",
               "n_snapshots=3", "seed=4"], device="cpu")
    arrays = tgen.generate_burgers_arrays(3, [32, 16], 3, 4, device="cpu")
    files = tgen.burgers_files(str(out), arrays)
    name = "1D_Burgers_Sols_Nu0.001.hdf5"
    assert sorted(files) == sorted(
        [str(out / name)] + [str(out / f"burgers_{r}_0.001" / name)
                             for r in (16, 32)])
    for path, u in files.items():
        got = jio.read_pdebench_h5(path)
        np.testing.assert_array_equal(got["u"], u)
        assert got["u"].shape == (3, 3, u.shape[-1])
        np.testing.assert_allclose(got["x"], np.arange(u.shape[-1])
                                   / u.shape[-1], atol=1e-7)
    np.testing.assert_array_equal(arrays["by_res"][32],
                                  jio.read_pdebench_h5(str(out / name))["u"])


def test_generate_data_darcy_writes_what_jax_reads(tmp_path):
    out = tmp_path / "darcy"
    tgen.main(["pde=darcy", f"out={out}", "n=3", "resolutions=[16,8]",
               "seed=2"], device="cpu")
    arrays = tgen.generate_darcy_arrays(3, [16, 8], 2, device="cpu")
    assert arrays["beta"] == "0.01" and sorted(arrays["cg"]) == [8, 16]
    assert sorted(os.listdir(out)) == [
        "darcy_flow.h5", "darcy_flow_beta_0.01.hdf5",
        "darcy_flow_beta_0.01_16.hdf5", "darcy_flow_beta_0.01_8.hdf5"]
    for path, d in tgen.darcy_files(str(out), arrays).items():
        got = jio.read_darcy_h5(path)
        np.testing.assert_array_equal(got["a"], d["a"])
        np.testing.assert_array_equal(got["u"], d["u"])
    base = jio.read_darcy_h5(str(out / "darcy_flow.h5"))
    assert base["a"].shape == (3, 16, 16)
