"""Hygiene of the port (resolution_pde_tpu_torch): it never imports JAX or
the JAX package (nor h5py, unless it reads an HDF5 file), runs on the card
unless asked for the CPU (its CLI entry points too), refuses a CUDA device
without CUDA, and on the CPU runs the plain versions and never launches a
kernel.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from resolution_pde_tpu_torch.deploy import ServingEngine
from resolution_pde_tpu_torch.models import FFNO2D, S4Model
from resolution_pde_tpu_torch.ops.kernels import (cauchy, fused_ff,
                                                  spectral_mix, vandermonde)

REPO = Path(__file__).resolve().parents[1]
SLICE_MODULES = [
    "resolution_pde_tpu_torch",
    "resolution_pde_tpu_torch.ops.grids",
    "resolution_pde_tpu_torch.ops.normalizers",
    "resolution_pde_tpu_torch.ops.losses",
    "resolution_pde_tpu_torch.ops.spectral",
    "resolution_pde_tpu_torch.ops.ssm",
    "resolution_pde_tpu_torch.ops.kernels._build",
    "resolution_pde_tpu_torch.ops.kernels._cost",
    "resolution_pde_tpu_torch.ops.kernels.fused_ff",
    "resolution_pde_tpu_torch.ops.kernels.spectral_mix",
    "resolution_pde_tpu_torch.ops.kernels.vandermonde",
    "resolution_pde_tpu_torch.ops.kernels.cauchy",
    "resolution_pde_tpu_torch.models",
    "resolution_pde_tpu_torch.models.layers",
    "resolution_pde_tpu_torch.models.ffno",
    "resolution_pde_tpu_torch.models.fno",
    "resolution_pde_tpu_torch.models.s4",
    "resolution_pde_tpu_torch.models.registry",
    "resolution_pde_tpu_torch.deploy",
    "resolution_pde_tpu_torch.deploy.serving",
    "resolution_pde_tpu_torch.utils.jax_bridge",
    "resolution_pde_tpu_torch.train",
    "resolution_pde_tpu_torch.train.schedules",
    "resolution_pde_tpu_torch.train.trainer",
    "resolution_pde_tpu_torch.train.checkpoint",
    "resolution_pde_tpu_torch.ops.resize",
    "resolution_pde_tpu_torch.data",
    "resolution_pde_tpu_torch.data.transforms",
    "resolution_pde_tpu_torch.data.io",
    "resolution_pde_tpu_torch.data.dataset",
    "resolution_pde_tpu_torch.data.loader",
    "resolution_pde_tpu_torch.data.factories",
    "resolution_pde_tpu_torch.configs",
    "resolution_pde_tpu_torch.utils.metrics",
    "resolution_pde_tpu_torch.evaluation",
    "resolution_pde_tpu_torch.evaluation.frequency",
    "resolution_pde_tpu_torch.evaluation.superres",
    "resolution_pde_tpu_torch.evaluation.rollout",
    "resolution_pde_tpu_torch.cli",
    "resolution_pde_tpu_torch.cli.common",
    "resolution_pde_tpu_torch.cli.main_1d",
    "resolution_pde_tpu_torch.cli.main_2d",
    "resolution_pde_tpu_torch.cli.autoregressive_eval",
    "resolution_pde_tpu_torch.cli.frequency_evaluation",
    "resolution_pde_tpu_torch.cli.generate_data",
    "resolution_pde_tpu_torch.cli.sweep",
    "resolution_pde_tpu_torch.datagen",
    "resolution_pde_tpu_torch.datagen.burgers",
    "resolution_pde_tpu_torch.datagen.darcy",
    "resolution_pde_tpu_torch.datagen.graphs",
    "resolution_pde_tpu_torch.datagen.ks",
    "resolution_pde_tpu_torch.datagen.navier_stokes",
    "resolution_pde_tpu_torch.datagen.random_fields",
    "resolution_pde_tpu_torch.datagen.writers",
]
CFG = dict(in_channels=1, out_channels=1, width=4, n_layers=2, n_modes=4,
           factor=2, n_ff_layers=2, layer_norm=True)


def test_port_never_imports_jax():
    code = ("import importlib, sys\n"
            f"for name in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m in ('jax', 'resolution_pde_tpu')\n"
            "             or m.startswith(('jax.', 'jaxlib', 'flax',\n"
            "                              'resolution_pde_tpu.')))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_port_imports_and_reads_mat_files_without_h5py(tmp_path):
    """h5py is imported only to read an HDF5 file: with it blocked every
    module imports, and read_ns reads a .mat file (scipy)."""
    from scipy.io import savemat

    u = np.arange(2 * 4 * 4 * 3, dtype=np.float32).reshape(2, 4, 4, 3)
    savemat(tmp_path / "u.mat", {"u": u})
    code = ("import importlib, sys\n"
            "sys.modules['h5py'] = None\n"
            f"for name in {SLICE_MODULES!r}:\n"
            "    importlib.import_module(name)\n"
            "from resolution_pde_tpu_torch.data.io import read_ns\n"
            f"print(read_ns({str(tmp_path / 'u.mat')!r}).shape)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "(2, 3, 4, 4)"


@pytest.mark.parametrize("entry", ["main_1d", "main_2d",
                                   "autoregressive_eval",
                                   "frequency_evaluation"])
def test_cli_entry_points_default_to_the_card(monkeypatch, entry):
    import importlib

    main = importlib.import_module(f"resolution_pde_tpu_torch.cli.{entry}").main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["model=ffno_2d", "dataset=ns_naive"])


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(FFNO2D(**CFG), device="cuda")


def test_serving_engine_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(FFNO2D(**CFG))


def test_trainer_defaults_to_the_card(monkeypatch):
    from resolution_pde_tpu_torch.train import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(FFNO2D(**CFG))


@pytest.mark.parametrize("spectral_impl", ["fft", "pallas", "pallas2"])
@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16])
def test_cpu_runs_plain_versions_and_launches_nothing(spectral_impl,
                                                      compute_dtype):
    start = (fused_ff.launches, spectral_mix.launches)
    eng = ServingEngine(FFNO2D(**CFG, spectral_impl=spectral_impl,
                               ff_impl="fused", compute_dtype=compute_dtype),
                        device="cpu")
    eng.warmup(spatial_shapes=[(8, 12)], batch_sizes=[2], rollout_steps=[2])
    x = np.random.default_rng(0).standard_normal((2, 1, 8, 12))
    assert np.isfinite(eng.predict(x)).all()
    assert np.isfinite(eng.forecast(x, 2)).all()
    assert (fused_ff.launches, spectral_mix.launches) == start == (0, 0)


@pytest.mark.parametrize("mode", ["dplr", "diag"])
def test_cpu_s4_serving_runs_plain_versions_and_launches_nothing(mode):
    """S4Model on the kernels' route (kernel_impl 'pallas') behind the
    ServingEngine on the CPU: finite outputs, no kernel launched."""
    start = (vandermonde.launches, cauchy.launches)
    model = S4Model(d_input=3, d_model=8, n_layers=2, mode=mode,
                    kernel_impl="pallas",
                    generator=torch.Generator().manual_seed(0))
    eng = ServingEngine(model, device="cpu")
    eng.warmup(spatial_shapes=[24], batch_sizes=[4], in_channels=3)
    x = np.random.default_rng(0).standard_normal((3, 3, 24))
    out = eng.predict(x)
    assert out.shape == (3, 1, 24) and np.isfinite(out).all()
    assert (vandermonde.launches, cauchy.launches) == start == (0, 0)


@pytest.mark.parametrize("ff_impl", ["fused", "fused_saved"])
def test_cpu_train_step_launches_nothing(ff_impl):
    """A train step on the CPU runs the plain forwards and backwards through
    the kernels' autograd Functions and launches no kernel."""
    from resolution_pde_tpu_torch.train import Trainer

    counters = (fused_ff.launches, fused_ff.bwd_launches,
                spectral_mix.launches, spectral_mix.adjoint_launches)
    trainer = Trainer(FFNO2D(**CFG, spectral_impl="pallas2", ff_impl=ff_impl,
                             compute_dtype=torch.bfloat16), device="cpu")
    state = trainer.init()
    x = np.random.default_rng(0).standard_normal((2, 1, 8, 12))
    state, loss = trainer.train_step(state, x, np.roll(x, 1, axis=-1))
    assert torch.isfinite(loss)
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in state.model.parameters())
    assert (fused_ff.launches, fused_ff.bwd_launches, spectral_mix.launches,
            spectral_mix.adjoint_launches) == counters == (0, 0, 0, 0)


def test_wrappers_refuse_other_devices():
    x = torch.zeros(2, 4, device="meta")
    k = torch.zeros(4, 4, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_ff.fused_feedforward(x, [k], [torch.zeros(4, device="meta")])
    x4 = torch.zeros(1, 4, 4, 2, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        spectral_mix.spectral_axis_pass(x4, None, 2, "ortho", torch.float32)


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No toolkit: building the kernels raises; nothing falls back."""
    from resolution_pde_tpu_torch.ops.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library_path()
    assert list(tmp_path.iterdir()) == []
