"""The port's figures (resolution_pde_tpu_torch/utils/plotting.py and
main_1d's ``save_figures``) against the JAX package's on the CPU.

Every plotting function, given the same seeded arrays (the port's as
torch tensors), writes the file JAX's writes, under the same name and at
the same pixel size; ``save_results_csv`` writes the same bytes.
``main_1d save_figures=true`` on a tiny KS run and a tiny 2D NS run with
``evaluation_type=use_resize`` writes JAX's set of figure files, its
super-resolution CSV within 1e-4 of JAX's: both runs evaluate JAX's
initial weights (``training.epochs=0``, the port warm-started from JAX's
checkpoint through utils.jax_bridge).
"""

import contextlib
import csv
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("matplotlib")
h5py = pytest.importorskip("h5py")
ocp = pytest.importorskip("orbax.checkpoint")
import matplotlib.image  # noqa: E402

from resolution_pde_tpu.cli.main_1d import main as jax_main  # noqa: E402
from resolution_pde_tpu.datagen.writers import write_ks_multires_tree  # noqa: E402
from resolution_pde_tpu.utils import plotting as JP  # noqa: E402
from resolution_pde_tpu_torch.cli import common  # noqa: E402
from resolution_pde_tpu_torch.cli.main_1d import main  # noqa: E402
from resolution_pde_tpu_torch.configs import parse_cli  # noqa: E402
from resolution_pde_tpu_torch.train import save_checkpoint  # noqa: E402
from resolution_pde_tpu_torch.utils import jax_bridge  # noqa: E402
from resolution_pde_tpu_torch.utils import plotting as P  # noqa: E402

KS_DIR = "visc_0.075_L64.0_lmax8_et5.0_nte51_nt51"


@contextlib.contextmanager
def _cwd(path):
    old = os.getcwd()
    os.makedirs(path, exist_ok=True)
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def _files(root) -> dict:
    """{relative path: PNG (height, width) or the CSV's bytes}."""
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            rel = os.path.relpath(path, root)
            if n.endswith(".png"):
                out[rel] = matplotlib.image.imread(path).shape[:2]
            else:
                with open(path, "rb") as f:
                    out[rel] = f.read()
    return out


def _calls(lib, t, root):
    """Every writer of ``lib`` on the same seeded data; ``t`` turns an
    array into what that package takes."""
    rng = np.random.default_rng(0)
    a = lambda *s: t(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    p1, y1, x1 = a(4, 1, 32), a(4, 1, 32), a(4, 1, 32)
    p2, y2 = a(3, 2, 16, 16), a(3, 2, 16, 16)
    freqs = t(np.linspace(0.0, 0.5, 9).astype(np.float32))
    err, mag = t(rng.random(9).astype(np.float32) + 0.1), \
        t(rng.random(9).astype(np.float32) + 1.0)
    results = {32: 0.125, 64: 0.0625, 128: 0.1}
    j = lambda n: os.path.join(root, n)  # noqa: E731
    lib.plot_1d_predictions(p1, y1, x1, save_path=j("p1.png"))
    lib.plot_2d_predictions(p2, y2, save_path=j("p2.png"))
    lib.plot_super_resolution(results, save_path=j("sr.png"), train_res=64)
    lib.plot_frequency_decomposition(err, mag, freqs, save_path=j("fd.png"))
    lib.plot_rollout(a(5, 32), a(5, 32), save_path=j("ro.png"))
    lib.save_results_csv(results, j("sr.csv"), columns=("resolution",
                                                         "rel_l2"))
    data1 = {32: {"inputs": x1, "predictions": p1, "targets": y1},
             64: {"inputs": a(4, 1, 64), "predictions": a(4, 1, 64),
                  "targets": a(4, 1, 64)}}
    data2 = {16: {"inputs": a(3, 2, 16, 16), "predictions": p2,
                  "targets": y2}}
    lib.plot_examples_multiple(data1, pde="ks", save_dir=j("m1"))
    lib.plot_examples_multiple(data2, pde="ns", save_dir=j("m2"),
                               spatial_ndim=2)
    lib.plot_ns_channels(data2, save_dir=j("nc"))
    lib.analyze_resize_frequencies(a(1, 1, 32, 32), 32, 16, save_dir=j("rf"))
    lib.plot_frequency_analysis({32: (err, mag, freqs),
                                 64: (err, mag, freqs)}, pde="ks",
                                current_res=32, save_dir=j("fa"))


def test_every_writer_writes_jax_file(tmp_path):
    _calls(JP, np.asarray, str(tmp_path / "jax"))
    _calls(P, torch.from_numpy, str(tmp_path / "port"))
    want = _files(tmp_path / "jax")
    got = _files(tmp_path / "port")
    assert len(want) == 11
    assert got == want  # names, pixel sizes and the CSV's bytes


def test_save_results_csv_is_byte_equal(tmp_path):
    results = {256: 0.012345678901234, 32: float("nan"), 64: 1e-7}
    JP.save_results_csv(results, str(tmp_path / "a" / "r.csv"))
    P.save_results_csv(results, str(tmp_path / "b" / "r.csv"))
    assert (tmp_path / "a" / "r.csv").read_bytes() \
        == (tmp_path / "b" / "r.csv").read_bytes()


def _ks(b, n, seed):
    rng = np.random.default_rng(seed)
    k = np.arange(n // 2 + 1)
    coef = (rng.standard_normal((b, k.size))
            + 1j * rng.standard_normal((b, k.size))) * (k < 6)
    step = np.exp(-0.3j * k - 0.01 * k ** 2)
    return np.stack([np.fft.irfft(coef * step ** t, n=n)
                     for t in range(10)], axis=1).astype(np.float32) * 3


def _ks_run(d):
    write_ks_multires_tree(str(d), {64: _ks(12, 64, 0), 32: _ks(12, 32, 1)},
                           split_counts=(8, 2, 2), dt=0.1)
    return ["model=ffno_1d", "dataset=ks_naive_true_mres1",
            f"dataset.dataset_params.saved_folder={d}",
            "dataset.dataset_params.data_mres_size={64: 8}",
            "dataset.dataset_params.downsample_from_res=64",
            f"dataset.eval_saved_folder={d}/res_64/{KS_DIR}",
            "dataset.original_res=64", "dataset.max_test_resolution=64",
            "dataset.rollout_steps=0", "model.width=8", "model.n_layers=1",
            "model.n_modes=16"], 1, jax_bridge.ffno1d_state_dict


def _ns_run(d):
    rng = np.random.default_rng(3)
    f = np.fft.rfft2(rng.standard_normal((8, 64, 64)))
    f[:, 6:-6, :] = 0
    f[:, :, 6:] = 0
    base = np.fft.irfft2(f, s=(64, 64)).astype(np.float32)
    with h5py.File(d / "ns.h5", "w") as fh:
        fh.create_dataset("u", data=np.stack(
            [np.roll(base, i, axis=-1) for i in range(3)], axis=1))
    return ["model=ffno_2d", "dataset=ns_naive",
            f"dataset.dataset_params.saved_folder={d}",
            "dataset.dataset_params.filename=ns.h5",
            "dataset.original_res=64", "dataset.max_test_resolution=64",
            "dataset.evaluation_type=use_resize", "dataset.rollout_steps=0",
            "model.width=8", "model.n_modes=4", "model.n_layers=1"], 2, \
        jax_bridge.ffno2d_state_dict


@pytest.mark.parametrize("run", [_ks_run, _ns_run], ids=["ks", "ns_resize"])
def test_main_save_figures_writes_jax_figures(tmp_path, monkeypatch, run):
    monkeypatch.delenv("SLURM_JOB_ID", raising=False)
    argv, ndim, bridge = run(tmp_path)
    argv = argv + ["training.epochs=0", "save_figures=true"]
    with _cwd(tmp_path / "jax"):
        want = jax_main(argv, spatial_ndim=ndim)
    raw = ocp.StandardCheckpointer().restore(
        os.path.abspath(tmp_path / "jax" / want["checkpoint"]), None)
    cfg = parse_cli(argv)
    model = common.build_model(cfg)
    model.load_state_dict(bridge(raw["params"]))
    init = str(tmp_path / "port_init")
    save_checkpoint(init, common.build_trainer(cfg, model, None,
                                               device="cpu").init())
    with _cwd(tmp_path / "port"):
        got = main(argv + [f"dataset.saved_checkpoint_path={init}"],
                   spatial_ndim=ndim, device="cpu")
    figs = {}
    for side in ("jax", "port"):
        (fig_dir,) = os.listdir(tmp_path / side / "figures")
        files = _files(tmp_path / side / "figures" / fig_dir)
        figs[side] = {k: v for k, v in files.items()
                      if not k.endswith(".csv")}
        with open(tmp_path / side / "figures" / fig_dir
                  / f"{cfg.dataset.pde}_super_resolution.csv") as f:
            figs[side + "_csv"] = list(csv.reader(f))
    assert sorted(figs["port"]) == sorted(figs["jax"])
    assert len(figs["jax"]) >= 5
    if ndim == 2:
        assert "resize_freq_64_to_32.png" in figs["jax"]
        assert "ns_channels_res64.png" in figs["jax"]
    rows_j, rows_p = figs["jax_csv"], figs["port_csv"]
    assert rows_p[0] == rows_j[0] == ["resolution", "rel_l2"]
    assert [r[0] for r in rows_p] == [r[0] for r in rows_j]
    np.testing.assert_allclose([float(r[1]) for r in rows_p[1:]],
                               [float(r[1]) for r in rows_j[1:]], rtol=1e-4)
    assert got["super_resolution"] == pytest.approx(
        want["super_resolution"], rel=1e-4)


def test_save_figures_without_matplotlib_raises_import_error(monkeypatch):
    """The card's machine has no matplotlib: the first figure raises
    matplotlib's ImportError, as JAX's writers do."""
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        P.plot_super_resolution({32: 0.1}, save_path="unused.png")
    with pytest.raises(ImportError):
        JP.plot_super_resolution({32: 0.1}, save_path="unused.png")
