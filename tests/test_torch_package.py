"""Hygiene of the port (resolution_pde_tpu_torch): it never imports JAX or
the JAX package, refuses a CUDA device without CUDA, and on the CPU runs
the plain versions and never launches a kernel.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from resolution_pde_tpu_torch.deploy import ServingEngine
from resolution_pde_tpu_torch.models import FFNO2D
from resolution_pde_tpu_torch.ops.kernels import fused_ff, spectral_mix

REPO = Path(__file__).resolve().parents[1]
SLICE_MODULES = [
    "resolution_pde_tpu_torch",
    "resolution_pde_tpu_torch.ops.grids",
    "resolution_pde_tpu_torch.ops.normalizers",
    "resolution_pde_tpu_torch.ops.losses",
    "resolution_pde_tpu_torch.ops.spectral",
    "resolution_pde_tpu_torch.ops.kernels._build",
    "resolution_pde_tpu_torch.ops.kernels.fused_ff",
    "resolution_pde_tpu_torch.ops.kernels.spectral_mix",
    "resolution_pde_tpu_torch.models",
    "resolution_pde_tpu_torch.models.layers",
    "resolution_pde_tpu_torch.models.ffno",
    "resolution_pde_tpu_torch.models.registry",
    "resolution_pde_tpu_torch.deploy",
    "resolution_pde_tpu_torch.deploy.serving",
    "resolution_pde_tpu_torch.utils.jax_bridge",
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


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(FFNO2D(**CFG), device="cuda")


@pytest.mark.parametrize("spectral_impl", ["fft", "pallas", "pallas2"])
@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16])
def test_cpu_runs_plain_versions_and_launches_nothing(spectral_impl,
                                                      compute_dtype):
    start = (fused_ff.launches, spectral_mix.launches)
    eng = ServingEngine(FFNO2D(**CFG, spectral_impl=spectral_impl,
                               ff_impl="fused", compute_dtype=compute_dtype))
    eng.warmup(spatial_shapes=[(8, 12)], batch_sizes=[2], rollout_steps=[2])
    x = np.random.default_rng(0).standard_normal((2, 1, 8, 12))
    assert np.isfinite(eng.predict(x)).all()
    assert np.isfinite(eng.forecast(x, 2)).all()
    assert (fused_ff.launches, spectral_mix.launches) == start == (0, 0)


def test_wrappers_refuse_other_devices():
    x = torch.zeros(2, 4, device="meta")
    k = torch.zeros(4, 4, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_ff.fused_feedforward(x, [k], [torch.zeros(4, device="meta")])
    x4 = torch.zeros(1, 4, 4, 2, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        spectral_mix.spectral_axis_pass(x4, None, None, None, 2,
                                        torch.float32)


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No toolkit: building the kernels raises; nothing falls back."""
    from resolution_pde_tpu_torch.ops.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library_path()
    assert list(tmp_path.iterdir()) == []
