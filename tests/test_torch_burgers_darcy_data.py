"""The port's Burgers and Darcy factories against the JAX package's on the
same small files, which the JAX package's writers make here from a numpy
seed (Burgers: 20 trajectories x 8 frames, the PDEBench file at 64
points and a true multi-resolution folder at 64 and 32; Darcy: 20
samples at 16²; the FNO-paper .mat files and the legacy .npy pair):
burger_markov_dataset (naive stride, low-pass, FFT resize, strides,
minmax), burger_true_multires_markov_dataset (subsampled buckets, the
add_res branch by stride, by low-pass and, in its resize flavor, by FFT),
burger_multires_markov_dataset and its resize flavor,
burger_window_dataset, load_burger_data_from_mat, darcy_dataset,
load_darcy_data_from_mat and load_darcy_data's 4-tuple; each with its
normalizers, some without. Compared: every split's arrays by bucket, the
normalizer statistics and the rollout set. The arrays held in memory
(``data.io.files_in_memory``, the true-multires glob included) give what
the files give; every Burgers and Darcy yaml instantiates through the
port as through JAX; burger_naive.yaml's window_size leaves the rollout
Markov.

Exact equality where no FFT is involved (the unencoded arrays and the
rollout); FFT paths and encoded arrays within 1e-4 relative (atol 1e-5);
normalizer statistics within 1e-6.
"""

import numpy as np
import pytest
from scipy.io import savemat

jax = pytest.importorskip("jax")
h5py = pytest.importorskip("h5py")

from resolution_pde_tpu import configs as jcfg  # noqa: E402
from resolution_pde_tpu.data import factories as jfac  # noqa: E402
from resolution_pde_tpu.data.dataset import (  # noqa: E402
    MultiResDataset as JMultiResDataset)
from resolution_pde_tpu.datagen.writers import (  # noqa: E402
    write_darcy_file, write_pdebench_file)
from resolution_pde_tpu_torch import configs as tcfg  # noqa: E402
from resolution_pde_tpu_torch.cli import common  # noqa: E402
from resolution_pde_tpu_torch.data import factories as tfac  # noqa: E402
from resolution_pde_tpu_torch.data import io as tio  # noqa: E402
from resolution_pde_tpu_torch.data.dataset import (  # noqa: E402
    ArrayDataset, MultiResDataset, MultiResTrajectoryDataset)

BURGERS = "1D_Burgers_Sols_Nu0.001.hdf5"


def _burgers(b, n, seed, t=8):
    """Smooth fields (modes below 6) under a per-mode phase and decay a
    frame."""
    rng = np.random.default_rng(seed)
    k = np.arange(n // 2 + 1)
    coef = (rng.standard_normal((b, k.size))
            + 1j * rng.standard_normal((b, k.size))) * (k < 6)
    step = np.exp(-0.3j * k - 0.02 * k ** 2)
    return np.stack([np.fft.irfft(coef * step ** i, n=n) for i in range(t)],
                    axis=1).astype(np.float32) * 2


def _darcy(n, s, seed):
    rng = np.random.default_rng(seed)
    a = np.where(rng.standard_normal((n, s, s)) > 0, 12.0, 3.0)
    u = rng.random((n, s, s)) * 1e-2 + a * 1e-3
    return a.astype(np.float32), u.astype(np.float32)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("burgers_darcy")
    by_res = {64: _burgers(20, 64, 0), 32: _burgers(20, 32, 1)}
    write_pdebench_file(str(d / BURGERS), by_res[64])
    for res, u in by_res.items():
        write_pdebench_file(str(d / f"burgers_{res}_0.001" / BURGERS), u)
    a, u = _darcy(20, 16, 2)
    write_darcy_file(str(d / "darcy_flow.h5"), a, u)
    savemat(d / "burgers1.mat", {"a": by_res[64][:, 0], "u":
                                 by_res[64][:, -1]})
    savemat(d / "burgers2.mat", {"a": by_res[64][:6, 1], "u":
                                 by_res[64][:6, 2]})
    savemat(d / "darcy.mat", {"coeff": a, "sol": u})
    np.save(d / "nu.npy", a)
    np.save(d / "tensor.npy", u[:, None])
    return d


def _close(a, b, exact):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    if exact:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def _check_norm(got, want):
    if want is None or isinstance(want, float):
        assert got == (None if want is None else pytest.approx(want,
                                                              rel=1e-6))
        return
    for attr in ("mean", "std"):
        np.testing.assert_allclose(getattr(got, attr).numpy(),
                                   np.asarray(getattr(want, attr)),
                                   rtol=1e-6, atol=1e-6)


def _pairs(got, want):
    if isinstance(want, (JMultiResDataset, MultiResDataset)):
        assert isinstance(got, MultiResDataset)
        assert got.resolutions == want.resolutions
        return [(got.buckets[r], want.buckets[r]) for r in want.resolutions]
    assert isinstance(got, ArrayDataset)
    return [(got, want)]


def _check(got, want, exact):
    """Every split's arrays by bucket (exact only when unencoded), the
    rollout set and the normalizer statistics."""
    assert len(got) == len(want)
    encoded = want[4] is not None
    for g, w in zip(got[:3], want[:3]):
        for gd, wd in _pairs(g, w):
            _close(gd.x, wd.x, exact and not encoded)
            _close(gd.y, wd.y, exact and not encoded)
    g_roll, w_roll = got[3], want[3]
    if w_roll is None:
        assert g_roll is None
    elif hasattr(w_roll, "buckets"):
        assert isinstance(g_roll, MultiResTrajectoryDataset)
        assert g_roll.resolutions() == w_roll.resolutions()
        for r in w_roll.resolutions():
            _close(g_roll.at(r).u, w_roll.at(r).u, exact)
    else:
        _close(g_roll.u, w_roll.u, exact)
    for g, w in zip(got[4:], want[4:]):
        _check_norm(g, w)


MARKOV = {
    "naive": (dict(reduced_resolution=2, normalization_type="simple"),
              True),
    "lowpass": (dict(reduced_resolution=2, use_low_pass_filter=True,
                     lowpass_cutoff_ratio=0.8), False),
    "resize": (dict(s=48, normalization_type="unit_gaussian"), False),
    "strides": (dict(reduced_batch=2, reduced_resolution_t=2,
                     num_samples_max=6), True),
    "minmax": ({}, True),
    "raw": (dict(data_normalizer=False), True),
}


@pytest.mark.parametrize("case", sorted(MARKOV))
def test_burger_markov_dataset(data, case):
    kw, exact = MARKOV[case]
    _check(tfac.burger_markov_dataset(BURGERS, str(data), **kw),
           jfac.burger_markov_dataset(BURGERS, str(data), **kw), exact)


TRUE_MRES = {
    "subsampled": ("naive", dict(data_mres_size={64: 10, 32: 12}), True),
    "add_res": ("naive", dict(data_mres_size={64: 16, 32: 0},
                              add_res=[16, 32, 64],
                              add_res_samples={16: 10, 32: 20}), True),
    "add_res_lowpass": ("naive", dict(data_mres_size={64: 16}, add_res=[16],
                                      add_res_samples={16: 10},
                                      use_low_pass_filter=True,
                                      lowpass_cutoff_ratio=0.9), False),
    "add_res_resize": ("resize", dict(data_mres_size={64: 16, 32: 9},
                                      add_res=[16], add_res_samples=10),
                       False),
    "minmax": ("naive", dict(data_mres_size={64: 16, 32: 16},
                             normalization_type="minmax"), True),
    "raw": ("resize", dict(data_mres_size={64: 9, 32: 16},
                           data_normalizer=False), True),
}


@pytest.mark.parametrize("case", sorted(TRUE_MRES))
def test_burger_true_multires_markov_dataset(data, case):
    flavor, kw, exact = TRUE_MRES[case]
    kw = dict(downsample_from_res=64, random_seed=5, num_samples_max=3,
              **kw)
    name = ("burger_true_multires_markov_dataset" if flavor == "naive"
            else "burger_resize_true_multires_markov_dataset")
    got = getattr(tfac, name)(str(data), **kw)
    _check(got, getattr(jfac, name)(str(data), **kw), exact)
    if case == "add_res":  # the extra buckets are there
        assert got[0].resolutions == [16, 32, 64]


@pytest.mark.parametrize("name,kw,exact", [
    ("burger_multires_markov_dataset",
     dict(reduced_resolution=2, add_res=[64, 16], num_add_res_samples=20,
          normalization_type="simple"), True),
    ("burger_resize_multires_markov_dataset",
     dict(reduced_resolution=2, add_res=16, num_add_res_samples=20), False),
    ("burger_multires_markov_dataset", dict(s=32, data_normalizer=False),
     False),
], ids=["naive", "resize", "one_bucket"])
def test_burger_multires_markov_dataset(data, name, kw, exact):
    got = getattr(tfac, name)(BURGERS, str(data), random_seed=3, **kw)
    _check(got, getattr(jfac, name)(BURGERS, str(data), random_seed=3,
                                    **kw), exact)


def test_burger_window_dataset(data):
    kw = dict(window_size=3, reduced_resolution=2)
    got = tfac.burger_window_dataset(BURGERS, str(data), **kw)
    _check(got, jfac.burger_window_dataset(BURGERS, str(data), **kw), False)
    assert got[0].x.shape[1:] == (3, 32)


@pytest.mark.parametrize("kw", [dict(res_scale=2),
                                dict(data_normalizer=False,
                                     split=(0.6, 0.2, 0.2))],
                         ids=["strided", "raw"])
def test_fno_paper_mat_loaders(data, kw):
    paths = (str(data / "burgers1.mat"), str(data / "burgers2.mat"))
    got = tfac.load_burger_data_from_mat(*paths, **kw)
    _check(got, jfac.load_burger_data_from_mat(*paths, **kw), not kw.get(
        "data_normalizer", True))
    assert sum(len(d.x) for d in got[:3]) == 26
    path = str(data / "darcy.mat")
    _check(tfac.load_darcy_data_from_mat(path, **kw),
           jfac.load_darcy_data_from_mat(path, **kw), False)


DARCY = {
    "unit_gaussian": ({}, False),
    "strides": (dict(reduced_batch=2, reduced_resolution=2,
                     num_samples_max=8, reduced_resolution_t=4), False),
    "simple": (dict(normalization_type="simple"), False),
    "raw": (dict(data_normalizer=False), True),
}


@pytest.mark.parametrize("case", sorted(DARCY))
def test_darcy_dataset(data, case):
    kw, exact = DARCY[case]
    got = tfac.darcy_dataset("darcy_flow.h5", str(data), **kw)
    _check(got, jfac.darcy_dataset("darcy_flow.h5", str(data), **kw), exact)
    assert got[3] is None and got[0].x.shape[1] == 1


def test_load_darcy_data(data):
    got = tfac.load_darcy_data(str(data), ntrain=14, ntest=4)
    want = jfac.load_darcy_data(str(data), ntrain=14, ntest=4)
    assert len(got) == 4
    for g, w in zip(got[:2], want[:2]):
        _close(g.x, w.x, False)
        _close(g.y, w.y, False)
    assert got[0].x.shape == (14, 1, 16, 16) and got[1].x.shape[0] == 4
    for g, w in zip(got[2:], want[2:]):
        _check_norm(g, w)


def test_arrays_in_memory_equal_the_files(data, tmp_path):
    """The factories read arrays held under paths (no such files exist)
    as they read the files: the PDEBench file, the true-multires folders
    found by their glob pattern, and the Darcy file."""
    held = tmp_path / "held"
    files = {str(held / BURGERS): tio.read_pdebench_h5(str(data / BURGERS))
             ["u"]}
    for res in (64, 32):
        files[str(held / f"burgers_{res}_0.001" / BURGERS)] = \
            tio.read_pdebench_h5(str(data / f"burgers_{res}_0.001" /
                                     BURGERS))["u"]
    files[str(held / "darcy_flow.h5")] = tio.read_darcy_h5(
        str(data / "darcy_flow.h5"))
    mres = dict(data_mres_size={64: 16, 32: 16}, add_res=[16],
                add_res_samples=10)
    calls = (
        lambda d: tfac.burger_markov_dataset(BURGERS, d,
                                             reduced_resolution=2),
        lambda d: tfac.burger_true_multires_markov_dataset(d, **mres),
        lambda d: tfac.darcy_dataset("darcy_flow.h5", d))
    assert not held.exists()
    with tio.files_in_memory(files):
        assert tio.glob_files(str(held / "burgers_32_0.001" /
                                  "1D_Burgers_Sols_Nu*.hdf5")) == [
            str(held / "burgers_32_0.001" / BURGERS)]
        assert tio.glob_files(str(held / "burgers_32_0.001" /
                                  "*.h5")) == []
        got = [call(str(held)) for call in calls]
    assert not tio.file_exists(str(held / BURGERS))
    for g, call in zip(got, calls):
        _check(g, call(str(data)), True)


BURGER_YAMLS = {
    "burger_naive": {},
    "burger_resize": {},
    "burger_naive_mres": dict(reduced_batch=2, reduced_resolution=2,
                              add_res=64, num_add_res_samples=10),
    "burger_resize_mres": dict(reduced_batch=2, reduced_resolution=2,
                               add_res=64, num_add_res_samples=10),
    "burger_naive_true_mres": dict(data_mres_size={64: 16, 32: 16},
                                   add_res=[16], add_res_samples={16: 10}),
    "burger_resize_true_mres": dict(data_mres_size={64: 16, 32: 16},
                                    add_res=[16], add_res_samples={16: 10}),
    "darcy": {},
}


@pytest.mark.parametrize("name", sorted(BURGER_YAMLS))
def test_every_burgers_and_darcy_yaml_instantiates(data, name):
    model = "fno_2d" if name == "darcy" else "fno_1d"
    params = dict(tcfg.load_config(model, name).dataset.dataset_params)
    params.update(saved_folder=str(data), **BURGER_YAMLS[name])
    if "s" in params:
        params["s"] = 48
    got = tcfg.instantiate_dataset(params)
    want = jcfg.instantiate_dataset(params)
    exact = "resize" not in name and name != "darcy"
    _check(got, want, exact)


def test_burgers_and_darcy_aliases_resolve_to_the_port_factories():
    for target, fn in (
            ("dataloaders.burger_naive_markov.burger_markov_dataset",
             tfac.burger_markov_dataset),
            ("dataloaders.cno_burger_markov.burger_markov_dataset",
             tfac.burger_markov_dataset),
            ("dataloaders.burger_naive_true_multires."
             "burger_true_multires_markov_dataset",
             tfac.burger_true_multires_markov_dataset),
            ("dataloaders.burger_resize_true_multires."
             "burger_true_multires_markov_dataset",
             tfac.burger_resize_true_multires_markov_dataset),
            ("dataloaders.burger_resize_multires."
             "burger_multires_markov_dataset",
             tfac.burger_resize_multires_markov_dataset),
            ("dataloaders.burger_s4.burger_window_dataset",
             tfac.burger_window_dataset),
            ("dataloaders.load_data.load_burger_data_from_mat",
             tfac.load_burger_data_from_mat),
            ("dataloaders.darcy_loader.get_darcy_dataset",
             tfac.darcy_dataset),
            ("dataloaders.load_data.load_darcy_data_from_mat",
             tfac.load_darcy_data_from_mat),
            ("dataloaders.load_data.load_darcy_data",
             tfac.load_darcy_data)):
        assert tcfg.dataset_factory(target) is fn, target


def test_burger_naive_window_size_leaves_the_rollout_markov():
    """burger_naive.yaml carries a top-level window_size of 15, which
    only a window dataset's rollout reads: FNO1d's rollout is Markov."""
    cfg = tcfg.parse_cli(["model=fno_1d", "dataset=burger_naive"])
    assert cfg.dataset.window_size == 15
    assert common.rollout_window_size(cfg) == 1
