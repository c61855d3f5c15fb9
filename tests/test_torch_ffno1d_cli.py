"""FFNO1D's command line on the CPU against the JAX package's:
``main_1d model=ffno_1d dataset=ks_naive_true_mres1`` on a small true
multi-resolution KS tree written here from a seed (20 trajectories x 10
frames at 64 and 32 points, split 16 / 2 / 2 into each resolution's
train, valid and test files). As the yaml ships it, the training set is
one bucket (the base resolution; its add_res samples are 0), a
MultiResDataset through the bucketed loader; then the eval swap to
ks_markov_dataset on the 64-point directory, the sweep at {32, 64} and a
rollout of 4 steps on each resolution's stored test trajectories.
Small widths (width 8, 2 layers, 24 modes; the yaml's 3 FeedForward
layers, LayerNorm, weight norm, GELU), dropout 0 (the two frameworks draw
other masks), through the dense FeedForward and the fused one.

Both runs start from the same weights: JAX's ``main_1d`` with
``training.epochs=0`` saves its initial state, whose params go through
utils.jax_bridge.ffno1d_state_dict into a port checkpoint that the port
warm-starts from; the JAX runs train from their own initial state, which
is those params for both FeedForwards (the same parameter tree).

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

from resolution_pde_tpu.cli.main_1d import main as jax_main  # noqa: E402
from resolution_pde_tpu.datagen.writers import write_ks_multires_tree  # noqa: E402
from resolution_pde_tpu_torch.cli import common  # noqa: E402
from resolution_pde_tpu_torch.cli.main_1d import main  # noqa: E402
from resolution_pde_tpu_torch.configs import parse_cli  # noqa: E402
from resolution_pde_tpu_torch.train import save_checkpoint  # noqa: E402
from resolution_pde_tpu_torch.utils.jax_bridge import ffno1d_state_dict  # noqa: E402

RTOL = 1e-4
DIR = "visc_0.075_L64.0_lmax8_et5.0_nte51_nt51"


@contextlib.contextmanager
def _cwd(path):
    old = os.getcwd()
    os.makedirs(path, exist_ok=True)
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def _ks(b, n, seed):
    rng = np.random.default_rng(seed)
    k = np.arange(n // 2 + 1)
    coef = (rng.standard_normal((b, k.size))
            + 1j * rng.standard_normal((b, k.size))) * (k < 6)
    step = np.exp(-0.3j * k - 0.01 * k ** 2)
    return np.stack([np.fft.irfft(coef * step ** t, n=n)
                     for t in range(10)], axis=1).astype(np.float32) * 3


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    d = tmp_path_factory.mktemp("ks_tree")
    write_ks_multires_tree(str(d), {64: _ks(20, 64, 0), 32: _ks(20, 32, 1)},
                           split_counts=(16, 2, 2), dt=0.1)
    return d


def _argv(d, *extra):
    return ["model=ffno_1d", "dataset=ks_naive_true_mres1",
            f"dataset.dataset_params.saved_folder={d}",
            "dataset.dataset_params.data_mres_size={64: 16}",
            "dataset.dataset_params.downsample_from_res=64",
            f"dataset.eval_saved_folder={d}/res_64/{DIR}",
            "dataset.original_res=64", "dataset.max_test_resolution=64",
            "dataset.rollout_steps=4", "model.width=8", "model.n_layers=2",
            "model.n_modes=24", "model.dropout=0", *extra]


@pytest.fixture(scope="module")
def init(tree, tmp_path_factory):
    """JAX's initial state (the same for both FeedForwards) as a port
    checkpoint."""
    tmp = tmp_path_factory.mktemp("ffno1d_init")
    with _cwd(tmp / "jax0"):
        out0 = jax_main(_argv(tree, "training.epochs=0",
                              "dataset.max_test_resolution=0",
                              "dataset.rollout_steps=0"))
    raw = ocp.StandardCheckpointer().restore(
        os.path.abspath(tmp / "jax0" / out0["checkpoint"]), None)
    cfg = parse_cli(_argv(tree))
    model = common.build_model(cfg)
    model.load_state_dict(ffno1d_state_dict(raw["params"]))
    path = str(tmp / "port_init")
    save_checkpoint(path, common.build_trainer(cfg, model, None,
                                               device="cpu").init())
    return path


@pytest.mark.parametrize("ff_impl", ["dense", "fused"])
def test_main_1d_ffno1d_matches_jax(tree, init, tmp_path, monkeypatch,
                                    ff_impl):
    monkeypatch.delenv("SLURM_JOB_ID", raising=False)
    argv = _argv(tree, "training.epochs=2", f"model.ff_impl={ff_impl}")
    with _cwd(tmp_path / "jax"):
        want = jax_main(argv)
    with _cwd(tmp_path / "port"):
        got = main(argv + [f"dataset.saved_checkpoint_path={init}"],
                   device="cpu")
    for k in ("train_loss", "val_loss", "lr"):
        np.testing.assert_allclose(getattr(got["history"], k),
                                   getattr(want["history"], k), rtol=RTOL)
    assert got["history"].train_loss[1] < got["history"].train_loss[0]
    assert got["test_loss"] == pytest.approx(want["test_loss"], rel=RTOL)
    for key in ("super_resolution", "rollout"):
        assert sorted(got[key]) == sorted(want[key]) == [32, 64]
        for res in want[key]:
            assert got[key][res] == pytest.approx(want[key][res],
                                                  rel=RTOL), (key, res)
    assert got["n_params"] == want["n_params"]
    assert got["checkpoint"] == os.path.join("checkpoints", "ffno1d",
                                             "ks_local")
