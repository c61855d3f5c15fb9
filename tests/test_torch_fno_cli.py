"""FNO's command lines on the CPU against the JAX package's:
``main_1d model=fno_1d dataset=burger_naive`` on a small PDEBench Burgers
file (20 trajectories x 8 frames at 64 points) and ``main_2d model=fno_2d
dataset=darcy`` on a small Darcy file (20 samples at 64²), both written
here from a seed, at small widths (width 8, 2 blocks). Burgers: the
PDEBench pairs, the sweep at {32, 64} and a rollout of 4 steps; Darcy:
unit-Gaussian normalizers, the sweep at {32, 64}, no rollout.

Both runs start from the same weights: JAX's command line with
``training.epochs=0`` saves its initial state, whose params go through
utils.jax_bridge.fno1d_state_dict / fno2d_state_dict into a port
checkpoint that the port warm-starts from; the JAX runs train from their
own initial state, which is those params. ``tests/conftest.py``'s 8
virtual devices make JAX's ``main_2d`` multiply ``training.batch_size`` by
8, so the port's 2D run gets 8 times the batch.

f32: the loss history, the test loss, every sweep resolution and the
rollout within 1e-4 relative.
"""

import contextlib
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
h5py = pytest.importorskip("h5py")
ocp = pytest.importorskip("orbax.checkpoint")

from resolution_pde_tpu.cli.main_1d import main as jax_main_1d  # noqa: E402
from resolution_pde_tpu.cli.main_2d import main as jax_main_2d  # noqa: E402
from resolution_pde_tpu.datagen.writers import (  # noqa: E402
    write_darcy_file, write_pdebench_file)
from resolution_pde_tpu_torch.cli import common  # noqa: E402
from resolution_pde_tpu_torch.cli.main_1d import main as main_1d  # noqa: E402
from resolution_pde_tpu_torch.cli.main_2d import main as main_2d  # noqa: E402
from resolution_pde_tpu_torch.configs import parse_cli  # noqa: E402
from resolution_pde_tpu_torch.train import save_checkpoint  # noqa: E402
from resolution_pde_tpu_torch.utils.jax_bridge import (  # noqa: E402
    fno1d_state_dict, fno2d_state_dict)

RTOL = 1e-4
JAX_DEVICES = 8  # tests/conftest.py


@contextlib.contextmanager
def _cwd(path):
    old = os.getcwd()
    os.makedirs(path, exist_ok=True)
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("fno_cli")
    rng = np.random.default_rng(7)
    k = np.arange(33)
    coef = (rng.standard_normal((20, 33))
            + 1j * rng.standard_normal((20, 33))) * (k < 6)
    step = np.exp(-0.3j * k - 0.02 * k ** 2)
    u = np.stack([np.fft.irfft(coef * step ** t, n=64) for t in range(8)],
                 axis=1).astype(np.float32)
    write_pdebench_file(str(d / "1D_Burgers_Sols_Nu0.001.hdf5"), u)
    f = np.fft.rfft2(rng.standard_normal((20, 64, 64)))
    f[:, 5:-5, :] = 0
    f[:, :, 5:] = 0
    a = np.where(np.fft.irfft2(f, s=(64, 64)) > 0, 12.0, 3.0)
    sol = np.fft.irfft2(np.fft.rfft2(1.0 / a) * np.exp(
        -0.01 * (np.arange(64)[:, None] ** 2 + np.arange(33) ** 2)),
        s=(64, 64)) * 1e-2
    write_darcy_file(str(d / "darcy_flow.h5"), a.astype(np.float32),
                     sol.astype(np.float32))
    return d


CASES = {
    "fno1d_burgers": (
        jax_main_1d, main_1d, fno1d_state_dict, 1,
        ["model=fno_1d", "dataset=burger_naive", "model.width=8",
         "model.n_blocks=2", "model.modes=12", "dataset.original_res=64",
         "dataset.max_test_resolution=64", "dataset.rollout_steps=4",
         "training.batch_size=16"]),
    "fno2d_darcy": (
        jax_main_2d, main_2d, fno2d_state_dict, JAX_DEVICES,
        ["model=fno_2d", "dataset=darcy", "model.width=8",
         "model.n_blocks=2", "model.modes1=6", "model.modes2=6",
         "dataset.original_res=64", "dataset.max_test_resolution=64",
         "training.batch_size=2"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fno_cli_matches_jax(data, tmp_path, monkeypatch, case):
    monkeypatch.delenv("SLURM_JOB_ID", raising=False)
    jax_main, main, bridge, batch_factor, argv = CASES[case]
    argv = argv + [f"dataset.dataset_params.saved_folder={data}"]
    with _cwd(tmp_path / "jax0"):
        out0 = jax_main(argv + ["training.epochs=0",
                                "dataset.max_test_resolution=0",
                                "dataset.rollout_steps=0"])
    raw = ocp.StandardCheckpointer().restore(
        os.path.abspath(tmp_path / "jax0" / out0["checkpoint"]), None)
    cfg = parse_cli(argv)
    model = common.build_model(cfg)
    model.load_state_dict(bridge(raw["params"]))
    init = str(tmp_path / "port_init")
    save_checkpoint(init, common.build_trainer(cfg, model, None,
                                               device="cpu").init())
    run = ["training.epochs=2"]
    with _cwd(tmp_path / "jax"):
        want = jax_main(argv + run)
    batch = cfg.training.batch_size * batch_factor
    with _cwd(tmp_path / "port"):
        got = main(argv + run + [f"training.batch_size={batch}",
                                 f"dataset.saved_checkpoint_path={init}"],
                   device="cpu")
    for k in ("train_loss", "val_loss", "lr"):
        np.testing.assert_allclose(getattr(got["history"], k),
                                   getattr(want["history"], k), rtol=RTOL)
    assert got["history"].train_loss[1] < got["history"].train_loss[0]
    assert got["test_loss"] == pytest.approx(want["test_loss"], rel=RTOL)
    assert sorted(got["super_resolution"]) == [32, 64]
    assert sorted(got["rollout"]) == ([32, 64] if case == "fno1d_burgers"
                                      else [])
    for key in ("super_resolution", "rollout"):
        assert sorted(got[key]) == sorted(want[key])
        for res in want[key]:
            assert got[key][res] == pytest.approx(want[key][res],
                                                  rel=RTOL), (key, res)
    assert got["n_params"] == want["n_params"]
    assert got["checkpoint"] == want["checkpoint"]
