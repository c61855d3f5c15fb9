"""The port's NS data path (data/) against the JAX package's on the same
small files, written here from a seed: read_ns on .h5 (both layouts) and
.mat; both NS factories with the naive stride, the low-pass, the FFT
resize ``s`` and add_res samples: train, val and test arrays, rollout
trajectories and normalizer stats; and the loaders' batch order.

Exact equality where no FFT is involved; FFT paths within 1e-4 relative
(atol 1e-5); normalizer stats within 1e-6 (relative, and absolute for
per-location stats near zero, whose inputs carry FFT roundoff).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
h5py = pytest.importorskip("h5py")
scipy_io = pytest.importorskip("scipy.io")

from resolution_pde_tpu.data import factories as jfac  # noqa: E402
from resolution_pde_tpu.data import io as jio  # noqa: E402
from resolution_pde_tpu.data import loader as jloader  # noqa: E402
from resolution_pde_tpu.data.dataset import (  # noqa: E402
    ArrayDataset as JArrayDataset, MultiResDataset as JMultiResDataset)
from resolution_pde_tpu_torch.data import factories as tfac  # noqa: E402
from resolution_pde_tpu_torch.data import io as tio  # noqa: E402
from resolution_pde_tpu_torch.data import loader as tloader  # noqa: E402
from resolution_pde_tpu_torch.data.dataset import (  # noqa: E402
    ArrayDataset, MinMaxNormalizer, MultiResDataset,
    MultiResTrajectoryDataset)


def _vorticity(b=10, t=6, n=32, seed=0):
    """Smooth fields (modes up to 5) shifted in time: (b, t, n, n)."""
    rng = np.random.default_rng(seed)
    f = np.fft.rfft2(rng.standard_normal((b, n, n)))
    f[:, 6:-5, :] = 0
    f[:, :, 6:] = 0
    base = np.fft.irfft2(f, s=(n, n)).astype(np.float32) * 10
    return np.stack([np.roll(base, i, axis=-1) for i in range(t)], axis=1)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("ns")
    u32, u16 = _vorticity(), _vorticity(n=16, seed=1)
    with h5py.File(d / "ns_32.h5", "w") as f:
        f.create_dataset("u", data=u32)
    with h5py.File(d / "ns_16.h5", "w") as f:
        f.create_dataset("u", data=u16)
    with h5py.File(d / "ns_bhwt.h5", "w") as f:
        f.create_dataset("u", data=np.transpose(u32, (0, 2, 3, 1)))
    scipy_io.savemat(d / "ns_32.mat", {"u": np.transpose(u32, (0, 2, 3, 1))})
    return d, u32


@pytest.mark.parametrize("name", ["ns_32.h5", "ns_bhwt.h5", "ns_32.mat"])
def test_read_ns(files, name):
    d, u = files
    got = tio.read_ns(str(d / name))
    np.testing.assert_array_equal(got, jio.read_ns(str(d / name)))
    np.testing.assert_array_equal(got, u)
    assert got.dtype == np.float32


def _close(a, b, exact):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    if exact:
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def _check_norm(tn, jn):
    if jn is None:
        assert tn is None
        return
    if isinstance(jn, float):
        assert tn == pytest.approx(jn, rel=1e-6)
        return
    for attr in ("mean", "std"):
        np.testing.assert_allclose(getattr(tn, attr).numpy(),
                                   np.asarray(getattr(jn, attr)),
                                   rtol=1e-6, atol=1e-6)


def _check_tuple(got, want, exact):
    assert len(got) == len(want)
    for g, w in zip(got[:3], want[:3]):
        if isinstance(w, JMultiResDataset):
            assert isinstance(g, MultiResDataset)
            assert g.resolutions == w.resolutions
            pairs = [(g.buckets[r], w.buckets[r]) for r in w.resolutions]
        else:
            assert isinstance(g, ArrayDataset)
            pairs = [(g, w)]
        for gd, wd in pairs:
            # encoded arrays: the normalizers' stats differ in the last
            # bits, so compare within f32 tolerance
            _close(gd.x, wd.x, exact=False)
            _close(gd.y, wd.y, exact=False)
    g_roll, w_roll = got[3], want[3]
    if hasattr(w_roll, "buckets"):
        assert isinstance(g_roll, MultiResTrajectoryDataset)
        assert g_roll.resolutions() == w_roll.resolutions()
        for r in w_roll.resolutions():
            _close(g_roll.at(r).u, w_roll.at(r).u, exact)
    else:
        _close(g_roll.u, w_roll.u, exact)
    for g, w in zip(got[4:], want[4:]):
        _check_norm(g, w)


NS_CASES = {
    "naive": (dict(reduced_resolution=2), True),
    "lowpass": (dict(reduced_resolution=2, use_low_pass_filter=True,
                     lowpass_cutoff_ratio=0.8), False),
    "resize": (dict(s=24), False),
    "strides": (dict(reduced_batch=2, reduced_resolution_t=2,
                     num_samples_max=4, normalization_type="simple"), True),
    "minmax": (dict(normalization_type="minmax"), True),
    "raw": (dict(data_normalizer=False), True),
}


@pytest.mark.parametrize("case", sorted(NS_CASES))
def test_ns_markov_dataset(files, case):
    d, _ = files
    kw, exact = NS_CASES[case]
    got = tfac.ns_markov_dataset("ns_32.h5", str(d), **kw)
    want = jfac.ns_markov_dataset("ns_32.h5", str(d), **kw)
    _check_tuple(got, want, exact)
    if case == "raw":  # unencoded: the split itself is exact
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g.x, w.x)
            np.testing.assert_array_equal(g.y, w.y)


MRES_CASES = {
    "naive": (dict(add_res=[8], add_res_samples={8: 10}), True),
    "lowpass": (dict(add_res=[8], add_res_samples={8: 10},
                     use_low_pass_filter=True), False),
    "subsampled": (dict(data_mres_size={32: 6, 16: 8}, add_res=[8, 16],
                        add_res_samples={8: 20, 16: 10},
                        normalization_type="minmax"), True),
}


@pytest.mark.parametrize("case", sorted(MRES_CASES))
def test_ns_true_multires_markov_dataset(files, case):
    d, _ = files
    kw, exact = MRES_CASES[case]
    kw = dict(file_map={32: "ns_32.h5", 16: "ns_16.h5"},
              downsample_from_res=32, random_seed=5, **kw)
    got = tfac.ns_true_multires_markov_dataset(str(d), **kw)
    want = jfac.ns_true_multires_markov_dataset(str(d), **kw)
    _check_tuple(got, want, exact)


def _batches(loader, epochs):
    return [[(x.copy(), y.copy()) for x, y in loader] for _ in range(epochs)]


def _same_batches(got, want):
    assert len(got) == len(want)
    for ge, we in zip(got, want):
        assert len(ge) == len(we)
        for (gx, gy), (wx, wy) in zip(ge, we):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)


@pytest.mark.parametrize("seed", [0, 7])
def test_loaders_draw_the_jax_batch_order(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((23, 1, 4, 4)).astype(np.float32)
    y = x * 2
    for shuffle in (True, False):
        t = tloader.Loader(ArrayDataset(x, y), 5, shuffle=shuffle, seed=seed)
        j = jloader.Loader(JArrayDataset(x, y), 5, shuffle=shuffle,
                           seed=seed)
        assert len(t) == len(j) == 5
        _same_batches(_batches(t, 2), _batches(j, 2))
        t.set_epoch(5)
        j.set_epoch(5)
        _same_batches(_batches(t, 1), _batches(j, 1))
    buckets = {r: (rng.standard_normal((n, 1, r)).astype(np.float32))
               for r, n in ((8, 11), (16, 7))}
    tm = MultiResDataset({r: ArrayDataset(a, a + 1)
                          for r, a in buckets.items()})
    jm = JMultiResDataset({r: JArrayDataset(a, a + 1)
                           for r, a in buckets.items()})
    t = tloader.ResolutionBucketedLoader(tm, 4, seed=seed, drop_last=True)
    j = jloader.ResolutionBucketedLoader(jm, 4, seed=seed, drop_last=True)
    assert len(t) == len(j) == 3
    _same_batches(_batches(t, 2), _batches(j, 2))
    t.set_epoch(3)
    j.set_epoch(3)
    _same_batches(_batches(t, 1), _batches(j, 1))
    tg = tloader.create_grouped_dataloaders(tm, tm, tm, 3, seed=seed)
    jg = jloader.create_grouped_dataloaders(jm, jm, jm, 3, seed=seed)
    for tl, jl in zip(tg, jg):
        _same_batches(_batches(tl, 2), _batches(jl, 2))


def test_minmax_normalizer_round_trip():
    n = MinMaxNormalizer(-2.0, 6.0)
    x = torch.linspace(-2, 6, 5)
    assert n.to("cpu") is n
    torch.testing.assert_close(n.encode(x), torch.linspace(0, 1, 5))
    torch.testing.assert_close(n.decode(n.encode(x)), x)
