"""CNO's resize training through the port's command line against the JAX
package's, on the CPU: ``main_2d model=cno_2d
training.cno_resize_training=true`` on a small vorticity file (11
trajectories x 5 frames at 64², written here from a seed), the model at a
small width (2 levels, 1 residual block a level and in the neck,
multiplier 4) built for 32² (``dataset.cno_train_size``), so every batch
is resized 64² -> 32² in the loop; the sweep at {32, 64} and a rollout of
2 steps, both through the resize round trip of a fixed-size model.

Both runs start from the same weights and BatchNorm statistics: JAX's
command line with ``training.epochs=0`` saves its initial variables, which
utils.jax_bridge.cno2d_state_dict maps into a port checkpoint that the port
warm-starts from; the JAX runs train from their own initial state.
``tests/conftest.py``'s 8 virtual devices make JAX's ``main_2d`` multiply
``training.batch_size`` by 8, so the port gets 8 times the batch: 16, which
leaves a straggler of 3 of the 35 training pairs (JAX replicates it over
its mesh; the port has one device). With ``accum_steps=2`` that straggler
is padded to 4 inside the step, the pad entering the BatchNorm statistics
in both.

f32: the loss history, the test loss, every sweep resolution and the
rollout within 1e-4 relative; the plain case over 2 epochs, the
accumulating one over 1. The eval-mode numbers of a BatchNorm model are
ill-conditioned in the biases of the convs in front of its norms: their
gradient is zero in exact arithmetic, so each side's is its own roundoff,
which Adam scales up into steps, and the running means follow those
biases. The train losses agree within 2e-7 over 2 epochs either way, the
eval-mode losses within 3e-5 (accum 1) and 1.1e-4 (accum 2) after the
second epoch and 1e-5 after the first (measured on the CPU).
"""

import contextlib
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
h5py = pytest.importorskip("h5py")
ocp = pytest.importorskip("orbax.checkpoint")

from resolution_pde_tpu.cli.main_2d import main as jax_main  # noqa: E402
from resolution_pde_tpu_torch.cli import common  # noqa: E402
from resolution_pde_tpu_torch.cli.main_2d import main  # noqa: E402
from resolution_pde_tpu_torch.configs import parse_cli  # noqa: E402
from resolution_pde_tpu_torch.train import save_checkpoint  # noqa: E402
from resolution_pde_tpu_torch.utils.jax_bridge import (  # noqa: E402
    cno2d_state_dict)

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
def data_dir(tmp_path_factory):
    """11 trajectories x 5 frames at 64²: smooth fields shifted in time."""
    d = tmp_path_factory.mktemp("cno_cli")
    rng = np.random.default_rng(5)
    f = np.fft.rfft2(rng.standard_normal((11, 64, 64)))
    f[:, 6:-6, :] = 0
    f[:, :, 6:] = 0
    base = np.fft.irfft2(f, s=(64, 64)).astype(np.float32)
    u = np.stack([np.roll(base, i, axis=-1) for i in range(5)], axis=1)
    with h5py.File(d / "ns.h5", "w") as fh:
        fh.create_dataset("u", data=u)
    return d


def _argv(d, *extra):
    return ["model=cno_2d", "dataset=ns_naive",
            f"dataset.dataset_params.saved_folder={d}",
            "dataset.dataset_params.filename=ns.h5",
            "dataset.original_res=64", "dataset.max_test_resolution=64",
            "dataset.cno_train_size=32", "dataset.rollout_steps=2",
            "training.cno_resize_training=true", "model.N_layers=2",
            "model.N_res=1", "model.N_res_neck=1",
            "model.channel_multiplier=4", *extra]


@pytest.fixture(scope="module")
def port_init(data_dir, tmp_path_factory):
    """JAX's initial variables (main_2d, 0 epochs) as a port checkpoint."""
    tmp = tmp_path_factory.mktemp("cno_init")
    with _cwd(tmp / "jax0"):
        out = jax_main(_argv(data_dir, "training.epochs=0",
                             "training.batch_size=2",
                             "dataset.max_test_resolution=0",
                             "dataset.rollout_steps=0"))
    raw = ocp.StandardCheckpointer().restore(
        os.path.abspath(tmp / "jax0" / out["checkpoint"]), None)
    cfg = parse_cli(_argv(data_dir))
    model = common.build_model(cfg)
    model.load_state_dict(cno2d_state_dict(
        {"params": raw["params"], **raw["model_state"]},
        n_res=cfg.model.N_res))
    path = str(tmp / "port_init")
    save_checkpoint(path, common.build_trainer(cfg, model, None,
                                               device="cpu").init())
    return path


@pytest.mark.parametrize("accum,epochs", [(1, 2), (2, 1)])
def test_cno_resize_cli_matches_jax(data_dir, port_init, tmp_path,
                                    monkeypatch, accum, epochs):
    monkeypatch.delenv("SLURM_JOB_ID", raising=False)
    run = [f"training.epochs={epochs}", f"training.accum_steps={accum}"]
    with _cwd(tmp_path / "jax"):
        want = jax_main(_argv(data_dir, *run, "training.batch_size=2"))
    with _cwd(tmp_path / "port"):
        got = main(_argv(data_dir, *run,
                         f"training.batch_size={2 * JAX_DEVICES}",
                         f"dataset.saved_checkpoint_path={port_init}"),
                   device="cpu")
    for k in ("train_loss", "val_loss", "lr"):
        np.testing.assert_allclose(getattr(got["history"], k),
                                   getattr(want["history"], k), rtol=RTOL)
    assert len(got["history"].train_loss) == epochs
    if epochs > 1:
        assert got["history"].train_loss[1] < got["history"].train_loss[0]
    assert got["test_loss"] == pytest.approx(want["test_loss"], rel=RTOL)
    for key in ("super_resolution", "rollout"):
        assert sorted(got[key]) == sorted(want[key]) == [32, 64]
        for res in want[key]:
            assert got[key][res] == pytest.approx(want[key][res],
                                                  rel=RTOL), (key, res)
    assert got["n_params"] == want["n_params"]
    assert got["checkpoint"] == want["checkpoint"]
