"""The port's NS generator against the JAX package's: GaussianRF's
spectrum (dims 1 to 3) and a sample from the same numpy normals (1e-5),
the vorticity solver from the same numpy initial condition and forcing
(32² and 64², two or three snapshots of a few steps; relative L2 1e-4),
viscous decay without forcing, ``generate_ns_dataset``'s batches,
``generate_ns_arrays``'s shapes and layout, the NS files (HDF5 and .mat)
and the Well files the port writes read back by JAX's readers and by the
port's to the same arrays, and ``generate_data``'s options, refusals and
device default.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
h5py = pytest.importorskip("h5py")
import jax.numpy as jnp  # noqa: E402

from resolution_pde_tpu.data import io as jio  # noqa: E402
from resolution_pde_tpu.datagen import navier_stokes as jns  # noqa: E402
from resolution_pde_tpu.datagen import random_fields as jrf  # noqa: E402
from resolution_pde_tpu_torch.cli import generate_data as tgen  # noqa: E402
from resolution_pde_tpu_torch.data import io as tio  # noqa: E402
from resolution_pde_tpu_torch.datagen import (  # noqa: E402
    GaussianRF,
    generate_ns_dataset,
    navier_stokes_2d,
    ns_forcing,
    write_ns_file,
    write_ns_mat,
)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _normals(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("dim,size", [(1, 16), (2, 16), (3, 8)])
def test_grf_spectrum_equals_jax(dim, size):
    for alpha, tau in ((2.0, 3.0), (2.5, 7.0)):
        j = jrf.GaussianRF(dim, size, alpha=alpha, tau=tau)
        t = GaussianRF(dim, size, alpha=alpha, tau=tau)
        np.testing.assert_array_equal(t.sqrt_eig.astype(np.float32),
                                      np.asarray(j.sqrt_eig))


@pytest.mark.parametrize("dim,size", [(1, 32), (2, 32)])
def test_grf_sample_from_normals_equals_jax(dim, size):
    xr, xi = _normals((3,) + (size,) * dim)
    j = jrf.GaussianRF(dim, size, alpha=2.5, tau=7.0)
    want = np.real(np.asarray(jnp.fft.ifftn(
        jax.lax.complex(j.sqrt_eig * xr, j.sqrt_eig * xi),
        axes=tuple(range(1, dim + 1)))))
    got = GaussianRF(dim, size, alpha=2.5, tau=7.0).from_normals(xr, xi)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # sample() draws its normals from the generator, then from_normals
    gen = torch.Generator().manual_seed(5)
    t = GaussianRF(dim, size, alpha=2.5, tau=7.0)
    xr_t, xi_t = t.normals(torch.Generator().manual_seed(5), 3)
    assert torch.equal(t.sample(gen, 3), t.from_normals(xr_t, xi_t))


@pytest.mark.parametrize("n,steps,record", [(32, 30, 3), (64, 20, 2)])
def test_navier_stokes_equals_jax(n, steps, record):
    xr, xi = _normals((2, n, n), seed=n)
    w0 = GaussianRF(2, n, alpha=2.5, tau=7.0).from_normals(xr, xi).numpy()
    f = ns_forcing(n)
    want, want_t = jns.navier_stokes_2d(jnp.asarray(w0), jnp.asarray(f),
                                        1e-3, steps * 1e-3, 1e-3, record)
    got, got_t = navier_stokes_2d(torch.as_tensor(w0), f, 1e-3,
                                  steps * 1e-3, 1e-3, record)
    assert got.dtype == torch.float32 and got.shape == (2, n, n, record)
    assert _rel(got.numpy(), want) < 1e-4
    np.testing.assert_allclose(got_t, np.asarray(want_t), rtol=1e-6)


def test_navier_stokes_viscous_decay():
    """Unforced flow loses enstrophy under viscosity (JAX
    tests/test_datagen.py test_ns_solver_viscous_decay)."""
    w0 = GaussianRF(2, 32, alpha=2.5, tau=7.0).sample(
        torch.Generator().manual_seed(2), 1)
    sol, _ = navier_stokes_2d(w0, np.zeros((32, 32), np.float32), visc=1e-2,
                              T=0.5, delta_t=1e-3, record_steps=4)
    energy = [float((sol[..., i] ** 2).sum()) for i in range(4)]
    assert all(a > b for a, b in zip(energy, energy[1:]))


def test_generate_ns_dataset_batches():
    """The reference driver's port: (a, u, t) with u solved from a in
    batches of batch_size (the last one short)."""
    a, u, t = generate_ns_dataset(torch.Generator().manual_seed(3), 3, s=16,
                                  viscosity=1e-3, T=0.02, delta_t=1e-3,
                                  record_steps=2, batch_size=2)
    assert a.shape == (3, 16, 16) and u.shape == (3, 16, 16, 2)
    np.testing.assert_allclose(t, [0.01, 0.02])
    for lo, hi in ((0, 2), (2, 3)):
        sol, _ = navier_stokes_2d(torch.as_tensor(a[lo:hi]), ns_forcing(16),
                                  1e-3, 0.02, 1e-3, 2)
        np.testing.assert_array_equal(u[lo:hi], sol.numpy())


def test_generate_ns_arrays_shapes_and_layout():
    arrays = tgen.generate_ns_arrays(3, [16, 32], 2, seed=4,
                                     viscosity="1e-03", device="cpu")
    assert sorted(arrays["by_res"]) == [16, 32] and arrays["visc"] == "1e-03"
    np.testing.assert_allclose(arrays["t"], [0.1, 0.2])
    # the first draw goes to the largest resolution; frame t is the
    # solver's snapshot t, laid out (n, t, h, w)
    w0 = GaussianRF(2, 32, alpha=2.5, tau=7.0).sample(
        torch.Generator().manual_seed(4), 3)
    sol, _ = navier_stokes_2d(w0, ns_forcing(32), visc=1e-3, T=0.2,
                              delta_t=1e-3, record_steps=2)
    for res, u in arrays["by_res"].items():
        assert u.shape == (3, 2, res, res) and u.dtype == np.float32
        assert u.flags.c_contiguous and np.isfinite(u).all()
    np.testing.assert_array_equal(arrays["by_res"][32],
                                  sol.permute(0, 3, 1, 2).numpy())


def test_ns_files_read_back_by_both_readers(tmp_path):
    rng = np.random.default_rng(1)
    u = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    a, t = u[:, 0], np.array([0.1, 0.2, 0.3], np.float32)
    # the solver's (n, h, w, t) layout is stored canonically
    write_ns_file(str(tmp_path / "ns.h5"), np.moveaxis(u, 1, -1), a=a, t=t)
    write_ns_mat(str(tmp_path / "ns.mat"), u, a=a, t=t)
    for name in ("ns.h5", "ns.mat"):
        path = str(tmp_path / name)
        np.testing.assert_array_equal(jio.read_ns(path), u)
        np.testing.assert_array_equal(tio.read_ns(path), u)
    with h5py.File(tmp_path / "ns.h5", "r") as f:
        assert f["u"].shape == (2, 3, 8, 8)
        np.testing.assert_array_equal(f["a"][()], a)
        np.testing.assert_array_equal(f["t"][()], t)


def test_generate_data_ns_and_active_files(tmp_path):
    arrays = tgen.main(["pde=ns", f"out={tmp_path}", "n=2",
                        "resolutions=[16]", "n_snapshots=2",
                        "viscosity=1e-03", "seed=3"], device="cpu")
    tgen.main(["pde=ns", f"out={tmp_path}", "n=2", "resolutions=[16]",
               "n_snapshots=2", "viscosity=1e-03", "seed=3", "format=mat"],
              device="cpu")
    u = arrays["by_res"][16]
    for name in ("ns_16_1e-03.h5", "ns_16_1e-03.mat"):
        np.testing.assert_array_equal(jio.read_ns(str(tmp_path / name)), u)
        np.testing.assert_array_equal(tio.read_ns(str(tmp_path / name)), u)

    written = tgen.main(["pde=active", f"out={tmp_path}/well", "n=5",
                         "resolutions=[16]", "n_snapshots=2", "seed=3"],
                        device="cpu")
    assert [os.path.basename(p) for p in written] == [
        f"active_matter_{i}.hdf5" for i in range(4)]
    sizes = []
    for path in written:
        got = tio.read_active_matter_h5(path)
        np.testing.assert_array_equal(got, jio.read_active_matter_h5(path))
        assert got.shape[1:] == (2, 16, 16, 1) and np.isfinite(got).all()
        sizes.append(got.shape[0])
    assert sizes == [2, 1, 1, 1]


def test_generate_data_options():
    for argv in (["pde=ks", "format=mat"], ["pde=ns", "format=npz"],
                 ["pde=ns", "lmax=4"]):
        with pytest.raises(SystemExit):
            tgen.main(argv, device="cpu")


@pytest.mark.parametrize("pde", ["burgers", "darcy"])
def test_generate_data_burgers_darcy_default_to_the_card(monkeypatch,
                                                         tmp_path, pde):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tgen.main([f"pde={pde}", f"out={tmp_path}"])
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("pde", ["ns", "active"])
def test_generate_data_ns_defaults_to_the_card(monkeypatch, tmp_path, pde):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tgen.main([f"pde={pde}", f"out={tmp_path}"])
    assert not os.listdir(tmp_path)
