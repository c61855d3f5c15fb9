"""The port's KS Markov factories against the JAX package's on the same
small files, which the JAX package's writers make here from a numpy seed
(20 trajectories x 6 frames at 64 and 32 points; the naive files at 64, a
true multi-resolution tree at both, split 16 / 2 / 2; a PINO file):
ks_markov_dataset (naive stride, low-pass, FFT resize, strides),
ks_true_multires_markov_dataset (subsampled buckets, the add_res branch
by stride and by low-pass, minmax), ks_multires_markov_dataset and its
resize flavor, and
ks_pino_markov_dataset's 7-tuple; each with its normalizers and without.
Compared: every split's arrays by bucket, the normalizer statistics and
the rollout set. The array-level entries equal the file-reading
factories, and every KS dataset yaml instantiates through the port's
``instantiate_dataset`` to what JAX's gives.

Exact equality where no FFT is involved (the unencoded arrays and the
rollout); FFT paths and encoded arrays within 1e-4 relative (atol 1e-5);
normalizer statistics within 1e-6.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
h5py = pytest.importorskip("h5py")

from resolution_pde_tpu import configs as jcfg  # noqa: E402
from resolution_pde_tpu.data import factories as jfac  # noqa: E402
from resolution_pde_tpu.data.dataset import (  # noqa: E402
    MultiResDataset as JMultiResDataset)
from resolution_pde_tpu.datagen.writers import (  # noqa: E402
    write_ks_file, write_ks_multires_tree)
from resolution_pde_tpu_torch import configs as tcfg  # noqa: E402
from resolution_pde_tpu_torch.data import factories as tfac  # noqa: E402
from resolution_pde_tpu_torch.data.dataset import (  # noqa: E402
    ArrayDataset, MultiResDataset, MultiResTrajectoryDataset)
from resolution_pde_tpu_torch.data.io import read_ks_h5  # noqa: E402

VISC = dict(viscosity=0.075, L=64.0, lmax=8, et=5.0, nte=6, nt=6)


def _ks(b, n, seed):
    """Smooth fields (modes below 6) under a per-mode phase a frame."""
    rng = np.random.default_rng(seed)
    k = np.arange(n // 2 + 1)
    coef = (rng.standard_normal((b, k.size))
            + 1j * rng.standard_normal((b, k.size))) * (k < 6)
    step = np.exp(-0.4j * k - 0.01 * k ** 2)
    return np.stack([np.fft.irfft(coef * step ** t, n=n) for t in range(6)],
                    axis=1).astype(np.float32) * 3


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    d = tmp_path_factory.mktemp("ks")
    by_res = {64: _ks(20, 64, 0), 32: _ks(20, 32, 1)}
    u = by_res[64]
    for name, part in (("KS_train_2048.h5", u[:16]),
                       ("KS_valid.h5", u[16:18]), ("KS_test.h5", u[18:])):
        write_ks_file(str(d / name), part, dt=0.1)
    write_ks_multires_tree(str(d), by_res, split_counts=(16, 2, 2), dt=0.1,
                           **VISC)
    write_ks_file(str(d / "ks_pino.h5"), _ks(20, 64, 2), split="train")
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
    if isinstance(want, JMultiResDataset):
        assert isinstance(got, MultiResDataset)
        assert got.resolutions == want.resolutions
        return [(got.buckets[r], want.buckets[r]) for r in want.resolutions]
    assert isinstance(got, ArrayDataset)
    return [(got, want)]


def _check(got, want, exact, rollout=True):
    """Every split's arrays by bucket (exact only when unencoded), the
    rollout set and the normalizer statistics."""
    assert len(got) == len(want)
    encoded = want[4 if rollout else 3] is not None
    for g, w in zip(got[:3], want[:3]):
        for gd, wd in _pairs(g, w):
            _close(gd.x, wd.x, exact and not encoded)
            _close(gd.y, wd.y, exact and not encoded)
    stats = 3
    if rollout:
        stats = 4
        g_roll, w_roll = got[3], want[3]
        if hasattr(w_roll, "buckets"):
            assert isinstance(g_roll, MultiResTrajectoryDataset)
            assert g_roll.resolutions() == w_roll.resolutions()
            for r in w_roll.resolutions():
                _close(g_roll.at(r).u, w_roll.at(r).u, exact)
        else:
            _close(g_roll.u, w_roll.u, exact)
    for g, w in zip(got[stats:], want[stats:]):
        _check_norm(g, w)


MARKOV = {
    "naive": (dict(reduced_resolution=2), True),
    "lowpass": (dict(reduced_resolution=2, use_low_pass_filter=True,
                     lowpass_cutoff_ratio=0.8), False),
    "resize": (dict(s=48), False),
    "strides": (dict(reduced_batch=2, reduced_resolution_t=2,
                     num_samples_max=3), True),
    "raw": (dict(data_normalizer=False), True),
}


@pytest.mark.parametrize("case", sorted(MARKOV))
def test_ks_markov_dataset(tree, case):
    kw, exact = MARKOV[case]
    got = tfac.ks_markov_dataset("KS_train_2048.h5", str(tree), **kw)
    _check(got, jfac.ks_markov_dataset("KS_train_2048.h5", str(tree), **kw),
           exact)


TRUE_MRES = {
    "subsampled": (dict(data_mres_size={64: 10, 32: 12}), True),
    "add_res": (dict(data_mres_size={64: 16, 32: 0}, add_res=[16, 32, 64],
                     add_res_samples={16: 10, 32: 20}), True),
    "add_res_lowpass": (dict(data_mres_size={64: 16}, add_res=[16],
                             add_res_samples={16: 10},
                             use_low_pass_filter=True,
                             lowpass_cutoff_ratio=0.9), False),
    "minmax": (dict(data_mres_size={64: 16, 32: 16},
                    normalization_type="minmax"), True),
    "raw": (dict(data_mres_size={64: 9, 32: 16}, add_res=[16],
                 add_res_samples=10, data_normalizer=False), True),
}


@pytest.mark.parametrize("case", sorted(TRUE_MRES))
def test_ks_true_multires_markov_dataset(tree, case):
    kw, exact = TRUE_MRES[case]
    kw = dict(VISC, train_s=2048, downsample_from_res=64, random_seed=5,
              **kw)
    got = tfac.ks_true_multires_markov_dataset(str(tree), **kw)
    want = jfac.ks_true_multires_markov_dataset(str(tree), **kw)
    _check(got, want, exact)
    if case == "add_res":  # the extra buckets are there
        assert got[0].resolutions == [16, 32, 64]


def test_true_multires_array_entry_equals_the_files(tree):
    kw = dict(data_mres_size={64: 10, 32: 12}, add_res=[16],
              add_res_samples={16: 10}, downsample_from_res=64,
              random_seed=5)
    got = tfac.ks_true_multires_markov_dataset(str(tree), **VISC, **kw)
    u_by_res = {r: read_ks_h5(str(tree / f"res_{r}/visc_0.075_L64.0_lmax8_"
                                          "et5.0_nte6_nt6/KS_train_2048.h5"))
                ["u"] for r in (64, 32)}
    arr = tfac.ks_true_multires_splits(u_by_res, **kw)
    for g, a in zip(got[:3], arr[:3]):
        for r in a.resolutions:
            np.testing.assert_array_equal(g.buckets[r].x, a.buckets[r].x)
            np.testing.assert_array_equal(g.buckets[r].y, a.buckets[r].y)
    for r in arr[3].resolutions():
        np.testing.assert_array_equal(got[3].at(r).u, arr[3].at(r).u)
    for attr in ("mean", "std"):
        assert float(getattr(got[4], attr)) == float(getattr(arr[4], attr))


def test_markov_array_entry_equals_the_files(tree):
    got = tfac.ks_markov_dataset("KS_train_2048.h5", str(tree))
    us = [read_ks_h5(str(tree / f))["u"] for f in
          ("KS_train_2048.h5", "KS_valid.h5", "KS_test.h5")]
    arr = tfac.ks_markov_splits(*us)
    for g, a in zip(got[:3], arr[:3]):
        np.testing.assert_array_equal(g.x, a.x)
    np.testing.assert_array_equal(got[3].u, arr[3].u)


MULTIRES = {
    "naive": (tfac.ks_multires_markov_dataset,
              jfac.ks_multires_markov_dataset,
              dict(reduced_resolution=2, add_res=[64, 16],
                   num_add_res_samples=20), True),
    "resize": (tfac.ks_resize_multires_markov_dataset,
               jfac.ks_resize_multires_markov_dataset,
               dict(reduced_resolution=2, add_res=16,
                    num_add_res_samples=20), False),
    "one_bucket": (tfac.ks_multires_markov_dataset,
                   jfac.ks_multires_markov_dataset,
                   dict(s=32, data_normalizer=False), False),
}


@pytest.mark.parametrize("case", sorted(MULTIRES))
def test_ks_multires_markov_dataset(tree, case):
    port, ref, kw, exact = MULTIRES[case]
    got = port("KS_train_2048.h5", str(tree), random_seed=3, **kw)
    _check(got, ref("KS_train_2048.h5", str(tree), random_seed=3, **kw),
           exact)
    if case == "one_bucket":
        assert isinstance(got[0], ArrayDataset)


@pytest.mark.parametrize("kw", [dict(s=32), dict(data_normalizer=False)],
                         ids=["resize", "raw"])
def test_ks_pino_markov_dataset(tree, kw):
    got = tfac.ks_pino_markov_dataset("ks_pino.h5", str(tree), **kw)
    assert len(got) == 7
    _check(got, jfac.ks_pino_markov_dataset("ks_pino.h5", str(tree), **kw),
           "s" not in kw, rollout=False)
    with pytest.raises(ValueError, match="minmax"):
        tfac.ks_pino_markov_dataset("ks_pino.h5", str(tree),
                                    normalization_type="simple")


KS_YAMLS = {
    "ks_naive": {},
    "ks_resize": {},
    "ks_naive_mres": {},
    "ks_resize_mres": {},
    "ks_pino": {"filename": "ks_pino.h5"},
    "ks_naive_true_mres1": dict(VISC, data_mres_size={64: 16, 32: 12},
                                downsample_from_res=64,
                                add_res_samples={16: 10}, add_res=[16]),
}


@pytest.mark.parametrize("name", sorted(KS_YAMLS))
def test_every_ks_yaml_instantiates_through_the_port(tree, name):
    params = dict(tcfg.load_config("ffno_1d", name).dataset.dataset_params)
    params.update(saved_folder=str(tree), **KS_YAMLS[name])
    got = tcfg.instantiate_dataset(params)
    want = jcfg.instantiate_dataset(params)
    pino = name == "ks_pino"
    exact = name in ("ks_naive", "ks_naive_mres", "ks_naive_true_mres1")
    _check(got, want, exact, rollout=not pino)


def test_ks_aliases_resolve_to_the_port_factories():
    for target, fn in (
            ("ks_markov_dataset", tfac.ks_markov_dataset),
            ("dataloaders.ks_naive_markov.ks_markov_dataset",
             tfac.ks_markov_dataset),
            ("dataloaders.ks_resize_markov.ks_markov_dataset",
             tfac.ks_markov_dataset),
            ("dataloaders.ks_naive_true_multires."
             "ks_true_multires_markov_dataset",
             tfac.ks_true_multires_markov_dataset),
            ("dataloaders.ks_naive_multires.ks_multires_markov_dataset",
             tfac.ks_multires_markov_dataset),
            ("dataloaders.ks_resize_multires.ks_multires_markov_dataset",
             tfac.ks_resize_multires_markov_dataset),
            ("dataloaders.ks_pino_markov.ks_pino_markov_dataset",
             tfac.ks_pino_markov_dataset),
            ("dataloaders.ks_pino_resize_markov.ks_pino_markov_dataset",
             tfac.ks_pino_markov_dataset)):
        assert tcfg.dataset_factory(target) is fn, target
