"""The S4 family's command line on the CPU against the JAX package:
``main_1d model=s4_1d dataset=ks_s4`` (and ``s4d_1d``) on three small KS
files written here from a seed (4 trajectories x 24 frames x 64 points
each, the yaml's window of 15, so 9 windows a trajectory and a rollout of
9 steps), then ``autoregressive_eval`` and ``frequency_evaluation`` on the
same trained weights.

Both ``main_1d`` runs start from the same weights: JAX's ``main_1d`` with
``training.epochs=0`` saves its initial state, whose params go through
utils.jax_bridge into a port checkpoint that the port warm-starts from
(``dataset.saved_checkpoint_path``); the JAX run trains from its own
initial state, which is those params (its warm start fails under the
8-device test mesh, ROADMAP.md section 3). ``training.learning_rate=2e-3``
puts the state-space group at half the main rate (``ssm_lr`` 1e-3), and
the cosine schedule moves both after the epoch. Small widths (d_model 8,
2 layers) and dropout 0 (the two frameworks draw other masks).

f32: the loss history, the test loss, every super-resolution and rollout
resolution, the eval CLIs' tables and the frequency decomposition within
1e-4 relative.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
h5py = pytest.importorskip("h5py")
ocp = pytest.importorskip("orbax.checkpoint")

from resolution_pde_tpu.cli.autoregressive_eval import main as jax_ae  # noqa: E402
from resolution_pde_tpu.cli.frequency_evaluation import main as jax_fe  # noqa: E402
from resolution_pde_tpu.cli.main_1d import main as jax_main  # noqa: E402
from resolution_pde_tpu_torch.cli import common  # noqa: E402
from resolution_pde_tpu_torch.cli.autoregressive_eval import main as port_ae  # noqa: E402
from resolution_pde_tpu_torch.cli.frequency_evaluation import main as port_fe  # noqa: E402
from resolution_pde_tpu_torch.cli.main_1d import main  # noqa: E402
from resolution_pde_tpu_torch.configs import parse_cli  # noqa: E402
from resolution_pde_tpu_torch.train import save_checkpoint  # noqa: E402
from resolution_pde_tpu_torch.utils.jax_bridge import s4_model_state_dict  # noqa: E402

RTOL = 1e-4


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
def ks_dir(tmp_path_factory):
    """KS_{train,valid,test}.h5: smooth fields (8 Fourier modes) under a
    per-mode phase and decay a frame."""
    d = tmp_path_factory.mktemp("ks_cli")
    for i, split in enumerate(("train", "valid", "test")):
        rng = np.random.default_rng(10 + i)
        k = np.arange(33)
        coef = (rng.standard_normal((4, 33))
                + 1j * rng.standard_normal((4, 33))) * (k < 8)
        step = np.exp(-0.3j * k - 0.01 * k ** 2)
        u = np.stack([np.fft.irfft(coef * step ** t, n=64)
                      for t in range(24)], axis=1) * 4
        with h5py.File(d / f"KS_{split}.h5", "w") as f:
            f.create_group(split).create_dataset(
                "pde_24-64", data=u.astype(np.float32))
    return d


def _argv(d, model, *extra):
    return [f"model={model}", "dataset=ks_s4",
            f"dataset.dataset_params.saved_folder={d}",
            "dataset.dataset_params.filename=KS_train.h5",
            "dataset.dataset_params.val_filename=KS_valid.h5",
            "dataset.dataset_params.test_filename=KS_test.h5",
            "dataset.original_res=64", "dataset.max_test_resolution=64",
            "model.d_model=8", "model.n_layers=2", "model.dropout=0",
            "training.learning_rate=2e-3", *extra]


def _port_checkpoint(argv, jax_ckpt, path):
    """The params of a JAX checkpoint in a port checkpoint, with the
    optimizer the port's CLI builds for the config."""
    raw = ocp.StandardCheckpointer().restore(jax_ckpt, None)
    cfg = parse_cli(argv)
    model = common.build_model(cfg)
    model.load_state_dict(s4_model_state_dict(raw["params"]))
    save_checkpoint(path, common.build_trainer(cfg, model, None,
                                               device="cpu").init())
    return path


@pytest.fixture(scope="module")
def runs(ks_dir, tmp_path_factory):
    """Per model: JAX's initial state as a port checkpoint, JAX's 1-epoch
    run and its checkpoint."""
    cache = {}

    def get(model):
        if model not in cache:
            tmp = tmp_path_factory.mktemp(model)
            with _cwd(tmp / "jax0"):
                out0 = jax_main(_argv(ks_dir, model, "training.epochs=0",
                                      "dataset.max_test_resolution=0",
                                      "dataset.rollout_steps=0"))
            init = _port_checkpoint(
                _argv(ks_dir, model),
                os.path.abspath(tmp / "jax0" / out0["checkpoint"]),
                str(tmp / "port_init"))
            with _cwd(tmp / "jax"):
                want = jax_main(_argv(ks_dir, model, "training.epochs=1"))
            cache[model] = dict(
                tmp=tmp, init=init, want=want,
                jax_ckpt=os.path.abspath(tmp / "jax" / want["checkpoint"]))
        return cache[model]

    return get


@pytest.mark.parametrize("model", ["s4_1d", "s4d_1d"])
def test_main_1d_s4_matches_jax(ks_dir, runs, monkeypatch, model):
    monkeypatch.delenv("SLURM_JOB_ID", raising=False)
    r = runs(model)
    with _cwd(r["tmp"] / "port"):
        got = main(_argv(ks_dir, model, "training.epochs=1",
                         f"dataset.saved_checkpoint_path={r['init']}"),
                   device="cpu")
    want = r["want"]
    for k in ("train_loss", "val_loss", "lr"):
        np.testing.assert_allclose(getattr(got["history"], k),
                                   getattr(want["history"], k), rtol=RTOL)
    assert got["test_loss"] == pytest.approx(want["test_loss"], rel=RTOL)
    for key in ("super_resolution", "rollout"):
        assert sorted(got[key]) == sorted(want[key]) == [32, 64]
        for res in want[key]:
            assert got[key][res] == pytest.approx(want[key][res],
                                                  rel=RTOL), key
    assert np.isfinite(list(got["rollout"].values())).all()
    assert got["n_params"] == want["n_params"]
    assert got["checkpoint"] == os.path.join("checkpoints", "s4model",
                                             "ks_local")
    jax_runs = next((r["tmp"] / "jax" / "runs" / f"ks_{model}").iterdir())
    port_runs = next((r["tmp"] / "port" / "runs" / f"ks_{model}").iterdir())
    assert (sorted(p.name for p in port_runs.iterdir())
            == sorted(p.name for p in jax_runs.iterdir()))


def test_eval_clis_match_jax(ks_dir, runs, tmp_path):
    """autoregressive_eval and frequency_evaluation on JAX's trained
    weights (dplr), each CLI reading its own package's checkpoint."""
    r = runs("s4_1d")
    argv = _argv(ks_dir, "s4_1d")
    port_ckpt = _port_checkpoint(argv, r["jax_ckpt"], str(tmp_path / "ck"))
    with _cwd(tmp_path / "jax"):
        want = jax_ae(argv + [f"dataset.saved_checkpoint_path="
                              f"{r['jax_ckpt']}"])
        want_f = jax_fe(argv + [f"dataset.saved_checkpoint_path="
                                f"{r['jax_ckpt']}"])
    with _cwd(tmp_path / "port"):
        got = port_ae(argv + [f"dataset.saved_checkpoint_path={port_ckpt}"],
                      device="cpu")
        got_f = port_fe(argv + [f"dataset.saved_checkpoint_path="
                                f"{port_ckpt}"], device="cpu")
    for key in ("teacher_forcing", "rollout"):
        assert sorted(got[key]) == sorted(want[key]) == [32, 64]
        for res in want[key]:
            assert got[key][res] == pytest.approx(want[key][res], rel=RTOL)
    for res in want["rollout_per_step"]:
        np.testing.assert_allclose(got["rollout_per_step"][res],
                                   want["rollout_per_step"][res], rtol=RTOL)
    assert sorted(got_f) == sorted(want_f) == ["default"]
    for k in ("error_per_mode", "magnitude_per_mode", "frequencies"):
        np.testing.assert_allclose(got_f["default"][k], want_f["default"][k],
                                   rtol=RTOL, atol=1e-6)
    # the same tables under runs/
    for suffix in ("_rollout", "_freq"):
        j = next((tmp_path / "jax" / "runs" / f"ks_s4_1d{suffix}").iterdir())
        p = next((tmp_path / "port" / "runs" / f"ks_s4_1d{suffix}")
                 .iterdir())
        assert (sorted(f.name for f in p.iterdir())
                == sorted(f.name for f in j.iterdir()))


def test_frequency_evaluation_needs_a_checkpoint(ks_dir):
    with pytest.raises(ValueError, match="saved_checkpoint_path"):
        port_fe(_argv(ks_dir, "s4_1d"), device="cpu")


@pytest.mark.parametrize("entry", [port_ae, port_fe])
def test_eval_clis_default_to_the_card(ks_dir, monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry(_argv(ks_dir, "s4_1d"))
