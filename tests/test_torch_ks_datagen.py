"""The port's KS generator against the JAX package's: the ETDRK4
coefficients (exact: the same numpy code), the initial conditions from
the same amplitudes and phases (JAX's own draws fed to the port), the
solver from the same numpy initial condition (2 x 64 at visc 1.0 and
2 x 256 at visc 0.075, four snapshots; relative L2 1e-5 and max abs 1e-4,
f32 state in both); ``generate_data pde=ks`` as the port writes it, read
by JAX's and the port's ks_true_multires_markov_dataset to the same
arrays; its fallback for under-resolved grids against JAX's (the same
solve resolutions, from the printed lines); consecutive frames that
correlate (JAX tests/test_datagen.py's learnability check); and the
pdes not ported raising with their ROADMAP item.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
h5py = pytest.importorskip("h5py")
import jax.numpy as jnp  # noqa: E402

from resolution_pde_tpu.cli import generate_data as jgen  # noqa: E402
from resolution_pde_tpu.data import factories as jfac  # noqa: E402
from resolution_pde_tpu.datagen import ks as jks  # noqa: E402
from resolution_pde_tpu_torch.cli import generate_data as tgen  # noqa: E402
from resolution_pde_tpu_torch.data import factories as tfac  # noqa: E402
from resolution_pde_tpu_torch.datagen import ks as tks  # noqa: E402


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_etdrk4_coefficients_equal_jax():
    k = 2 * np.pi * np.fft.rfftfreq(128, d=64.0 / 128)
    lin = k ** 2 - 0.075 * k ** 4
    for got, want in zip(tks._etdrk4_coeffs(lin, 0.00375),
                         jks._etdrk4_coeffs(lin, 0.00375)):
        np.testing.assert_array_equal(got, want)


def test_initial_conditions_match_jax_from_the_same_draws():
    key = jax.random.key(4)
    want = np.asarray(jks.random_ks_initial_conditions(key, 3, 96, lmax=8))
    ka, kp = jax.random.split(key)
    amps = np.array(jax.random.normal(ka, (3, 8)))
    phases = np.array(jax.random.uniform(kp, (3, 8), minval=0,
                                         maxval=2 * np.pi))
    got = tks.ks_initial_conditions(torch.from_numpy(amps),
                                    torch.from_numpy(phases), 96).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    drawn = tks.random_ks_initial_conditions(
        torch.Generator().manual_seed(0), 3, 96)
    assert drawn.shape == (3, 96) and torch.isfinite(drawn).all()


@pytest.mark.parametrize("n,visc,dt,spb", [(64, 1.0, 0.05, 20),
                                           (256, 0.075, 0.00375, 27)])
def test_solve_ks_matches_jax(n, visc, dt, spb):
    rng = np.random.default_rng(n)
    amps = rng.standard_normal((2, 8)).astype(np.float32)
    phases = (2 * np.pi * rng.random((2, 8))).astype(np.float32)
    u0 = tks.ks_initial_conditions(torch.from_numpy(amps),
                                   torch.from_numpy(phases), n)
    got = tks.solve_ks(u0, visc=visc, dt=dt, n_snapshots=4,
                       steps_per_snapshot=spb).numpy()
    want = np.asarray(jks.solve_ks(jnp.asarray(u0.numpy()), visc=visc,
                                   dt=dt, n_snapshots=4,
                                   steps_per_snapshot=spb))
    assert got.shape == want.shape == (2, 4, n) and got.dtype == np.float32
    np.testing.assert_array_equal(got[:, 0], u0.numpy())
    assert _rel(got, want) <= 1e-5
    assert np.abs(got - want).max() <= 1e-4


def test_generated_tree_reads_the_same_in_jax_and_the_port(tmp_path):
    out = str(tmp_path / "ks")
    arrays = tgen.main(["pde=ks", f"out={out}", "n=20",
                        "resolutions=[64,32]", "n_snapshots=6", "et=0.5",
                        "seed=1"], device="cpu")
    assert arrays["split_counts"] == (16, 2, 2) and arrays["snap_dt"] == 0.1
    kw = dict(viscosity=1.0, L=64.0, lmax=8, et=0.5, nte=6, nt=6,
              data_mres_size={64: 16, 32: 12}, downsample_from_res=64,
              add_res=[16], add_res_samples={16: 10}, data_normalizer=False)
    got = tfac.ks_true_multires_markov_dataset(out, **kw)
    want = jfac.ks_true_multires_markov_dataset(out, **kw)
    assert got[0].resolutions == want[0].resolutions == [16, 32, 64]
    for g, w in zip(got[:3], want[:3]):
        for r in w.resolutions:
            np.testing.assert_array_equal(g.buckets[r].x, w.buckets[r].x)
            np.testing.assert_array_equal(g.buckets[r].y, w.buckets[r].y)
    for r in want[3].resolutions():
        np.testing.assert_array_equal(got[3].at(r).u, want[3].at(r).u)
    # the train file of each resolution holds its first 16 trajectories,
    # the test split of the 64-point one the last 3 of them
    np.testing.assert_array_equal(got[3].at(64).u,
                                  arrays["by_res"][64][13:16])
    naive = tfac.ks_markov_dataset("KS_train_2048.h5", out,
                                   data_normalizer=False)
    np.testing.assert_array_equal(naive[3].u, arrays["by_res"][64][18:])


def _solve_lines(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kw)
    return [ln for ln in buf.getvalue().splitlines() if "solving at" in ln]


@pytest.mark.parametrize("resolutions,visc", [([128, 64, 32], None),
                                              ([128, 64], "0.075")])
def test_under_resolved_grids_solve_where_jax_does(tmp_path, resolutions,
                                                   visc):
    args = dict(n=2, resolutions=resolutions, n_snapshots=2, seed=0,
                viscosity=visc, et=0.1)
    want = _solve_lines(jgen.generate_ks, str(tmp_path / "jax"), **args)
    got = _solve_lines(tgen.generate_ks, str(tmp_path / "port"), **args,
                       device="cpu")
    assert got == want and len(want) == (1 if visc is None else 2)


def test_generated_frames_are_learnable(tmp_path):
    arrays = tgen.generate_ks_arrays(6, [64], 11, 3, et=1.0, device="cpu")
    u = arrays["by_res"][64]
    assert np.isfinite(u).all() and abs(arrays["snap_dt"] - 0.1) < 1e-12
    a, b = u[:, :-1], u[:, 1:]
    corr = ((a * b).sum(-1)
            / np.sqrt((a * a).sum(-1) * (b * b).sum(-1) + 1e-12))
    assert corr.mean() > 0.8
    ident = (np.linalg.norm(b - a, axis=-1)
             / (np.linalg.norm(b, axis=-1) + 1e-12))
    assert ident.mean() < 0.7


@pytest.mark.parametrize("pde", tgen.NOT_PORTED)
def test_other_pdes_raise_with_their_item(pde):
    with pytest.raises(NotImplementedError,
                       match="ROADMAP.md section 1, item 8"):
        tgen.main([f"pde={pde}"], device="cpu")
    with pytest.raises(SystemExit, match="unknown pde"):
        tgen.main(["pde=wave"], device="cpu")


def test_generate_data_defaults_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tgen.main(["pde=ks", f"out={tmp_path}"])
    assert not os.listdir(tmp_path)
