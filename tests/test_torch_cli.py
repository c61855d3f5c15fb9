"""The port's command-line path (cli/main_2d.py) against the JAX
package's ``main_2d`` on the CPU, on a small vorticity file written here
from a seed.

Both CLIs start from the same weights: JAX's ``main_2d`` with
``training.epochs=0`` saves its initial state, whose params go through
utils.jax_bridge into a port checkpoint that the port warm-starts from
(``dataset.saved_checkpoint_path``). The JAX run trains from its own
initial state, which is those params: its warm start fails under the
8-device test mesh (its restored step lands on one device).
``tests/conftest.py``'s 8 virtual devices make JAX's 2D driver multiply
``training.batch_size`` by 8, so the port gets 8 times the batch.

f32: the loss history, test loss, every super-resolution and rollout
resolution within 1e-4 relative. bf16 through the kernel route (JAX's
Pallas kernels in interpret mode, the port's plain versions): within 2e-2
relative, the bf16 tolerance of tests/test_torch_ffno.py.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
h5py = pytest.importorskip("h5py")
ocp = pytest.importorskip("orbax.checkpoint")

from resolution_pde_tpu.cli.main_2d import main as jax_main  # noqa: E402
from resolution_pde_tpu_torch.cli import common  # noqa: E402
from resolution_pde_tpu_torch.cli.main_2d import main  # noqa: E402
from resolution_pde_tpu_torch.configs import parse_cli  # noqa: E402
from resolution_pde_tpu_torch.train import (Trainer,  # noqa: E402
                                            restore_checkpoint,
                                            save_checkpoint)
from resolution_pde_tpu_torch.utils.jax_bridge import ffno2d_state_dict  # noqa: E402

KERNEL_ROUTE = ["model.compute_dtype=bfloat16", "model.spectral_impl=pallas2",
                "model.ff_impl=fused", "model.approx_gelu=true"]
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
    """10 trajectories x 5 frames at 64^2: smooth fields shifted in time."""
    d = tmp_path_factory.mktemp("ns_cli")
    rng = np.random.default_rng(3)
    f = np.fft.rfft2(rng.standard_normal((10, 64, 64)))
    f[:, 6:-6, :] = 0
    f[:, :, 6:] = 0
    base = np.fft.irfft2(f, s=(64, 64)).astype(np.float32)
    u = np.stack([np.roll(base, i, axis=-1) for i in range(5)], axis=1)
    with h5py.File(d / "ns.h5", "w") as fh:
        fh.create_dataset("u", data=u)
    return d


def _argv(d, *extra):
    return ["model=ffno_2d", "dataset=ns_naive",
            f"dataset.dataset_params.saved_folder={d}",
            "dataset.dataset_params.filename=ns.h5",
            "dataset.original_res=64", "dataset.max_test_resolution=64",
            "dataset.rollout_steps=2", "model.width=8", "model.n_modes=4",
            "model.n_layers=2", "model.dropout=0", *extra]


def _port_init(d, tmp, route):
    """JAX's initial state (main_2d, 0 epochs) as a port checkpoint."""
    with _cwd(tmp / "jax0"):
        out = jax_main(_argv(d, *route, "training.epochs=0",
                             f"training.batch_size={2}",
                             "dataset.max_test_resolution=0",
                             "dataset.rollout_steps=0"))
    raw = ocp.StandardCheckpointer().restore(
        os.path.abspath(tmp / "jax0" / out["checkpoint"]), None)
    model = common.build_model(parse_cli(_argv(d, *route)))
    model.load_state_dict(ffno2d_state_dict(raw["params"]))
    path = str(tmp / "port_init")
    save_checkpoint(path, Trainer(model, device="cpu").init())
    return path


def _check(got, want, rel):
    for k in ("train_loss", "val_loss", "lr"):
        np.testing.assert_allclose(getattr(got["history"], k),
                                   getattr(want["history"], k), rtol=rel)
    assert got["test_loss"] == pytest.approx(want["test_loss"], rel=rel)
    for key in ("super_resolution", "rollout"):
        assert sorted(got[key]) == sorted(want[key]) == [32, 64]
        for r in want[key]:
            assert got[key][r] == pytest.approx(want[key][r], rel=rel), key


@pytest.mark.parametrize("route,epochs,rel", [
    ([], 2, 1e-4), (KERNEL_ROUTE, 1, 2e-2),
    # the ns_models sweep's ffno2d_ns leg: trained at 32² (the file
    # strided by 2), evaluated at 32² and at the file's 64²
    (["dataset.dataset_params.reduced_resolution=2"], 2, 1e-4)],
    ids=["f32", "kernel_route_bf16", "f32_trained_at_half_resolution"])
def test_main_2d_matches_jax(data_dir, tmp_path, monkeypatch, route, epochs,
                             rel):
    # the run checkpoint's name reads SLURM_JOB_ID, which the JAX sweep
    # driver sets in its process and another test file may leave behind
    monkeypatch.delenv("SLURM_JOB_ID", raising=False)
    init = _port_init(data_dir, tmp_path, route)
    run = [*route, f"training.epochs={epochs}"]
    with _cwd(tmp_path / "jax"):
        want = jax_main(_argv(data_dir, *run, "training.batch_size=2"))
    with _cwd(tmp_path / "port"):
        got = main(_argv(data_dir, *run, f"training.batch_size={2 * JAX_DEVICES}",
                         f"dataset.saved_checkpoint_path={init}"),
                   device="cpu")
    _check(got, want, rel)
    assert got["provenance"]["platform"] == "cpu"
    assert got["provenance"]["epochs"] == epochs
    assert got["n_params"] == want["n_params"]
    assert sorted(got["eval_seconds"]) == sorted(got["rollout_seconds"]) \
        == [32, 64]
    # the same tables under runs/, the checkpoint under checkpoints/
    jax_runs = next((tmp_path / "jax" / "runs" / "ns_ffno_2d").iterdir())
    port_runs = next((tmp_path / "port" / "runs" / "ns_ffno_2d").iterdir())
    assert (sorted(p.name for p in port_runs.iterdir())
            == sorted(p.name for p in jax_runs.iterdir()))
    assert got["checkpoint"] == os.path.join("checkpoints", "ffno2d",
                                             "ns_local")
    model = common.build_model(parse_cli(_argv(data_dir, *route)))
    state = Trainer(model, device="cpu").init()
    restore_checkpoint(str(tmp_path / "port" / got["checkpoint"]), state)
    assert state.step == len(got["history"].train_loss) * 2


def test_resume_is_bit_exact(data_dir, tmp_path):
    """A 2-epoch run resumed to 3 equals an uninterrupted 3-epoch run, bit
    for bit, with dropout on (its generator is in the checkpoint) and a
    cosine schedule (its epoch offset)."""
    run = ["model.dropout=0.1", "training.scheduler=cosine",
           "training.t_max=4", "training.batch_size=8"]
    with _cwd(tmp_path / "full"):
        full = main(_argv(data_dir, *run, "training.epochs=3"), device="cpu")
    with _cwd(tmp_path / "part"):
        part = main(_argv(data_dir, *run, "training.epochs=2",
                          "training.checkpoint_every=1"), device="cpu")
        resumed = main(_argv(data_dir, *run, "training.epochs=3",
                             f"training.resume_from={part['checkpoint']}"),
                       device="cpu")
    for k in ("train_loss", "val_loss", "lr"):
        assert getattr(resumed["history"], k) == getattr(full["history"], k)
    for key in ("test_loss", "super_resolution", "rollout"):
        assert resumed[key] == full[key], key


def test_main_defaults_to_the_card(data_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(_argv(data_dir))


@pytest.mark.parametrize("override,item", [
    ("save_figures=true", "item 8")])
def test_unported_options_raise(data_dir, override, item):
    with pytest.raises(NotImplementedError, match=item):
        main(_argv(data_dir, override), device="cpu")


def test_cno_resize_training_runs(data_dir, tmp_path, monkeypatch):
    """training.cno_resize_training (ported with CNO) on a
    resolution-flexible model: the 64² batches resized to
    dataset.cno_train_size=32 in the loop, the sweep round-tripping
    through 32²; the FFT resize of the sweep at 64 then gives the 32²
    numbers back."""
    monkeypatch.delenv("SLURM_JOB_ID", raising=False)
    with _cwd(tmp_path):
        out = main(_argv(data_dir, "training.cno_resize_training=true",
                         "dataset.cno_train_size=32", "training.epochs=1",
                         "training.batch_size=8"), device="cpu")
    assert np.isfinite(out["test_loss"])
    assert sorted(out["super_resolution"]) == [32, 64]
    assert all(np.isfinite(v) for v in out["super_resolution"].values())
    assert sorted(out["rollout"]) == [32, 64]


def test_eval_clis_repeat_main_2d(data_dir, tmp_path, monkeypatch):
    """autoregressive_eval on main_2d's checkpoint repeats main_2d's sweep
    and rollout (the spatial rank inferred from the 2D targets), and
    frequency_evaluation's radial decomposition is finite."""
    from resolution_pde_tpu_torch.cli import (autoregressive_eval,
                                              frequency_evaluation)

    monkeypatch.delenv("SLURM_JOB_ID", raising=False)
    with _cwd(tmp_path):
        out = main(_argv(data_dir, "training.epochs=1",
                         "training.batch_size=8"), device="cpu")
        ckpt = f"dataset.saved_checkpoint_path={out['checkpoint']}"
        argv = _argv(data_dir, ckpt, "training.batch_size=8",
                     "training.scheduler=step")
        ev = autoregressive_eval.main(argv, device="cpu")
        freq = frequency_evaluation.main(argv, device="cpu")
    assert ev["teacher_forcing"] == pytest.approx(out["super_resolution"],
                                                  rel=1e-6)
    assert ev["rollout"] == pytest.approx(out["rollout"], rel=1e-6)
    err = freq["default"]["error_per_mode"]
    assert err.shape == (64,) and np.isfinite(err).all()
