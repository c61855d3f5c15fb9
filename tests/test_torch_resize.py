"""The port's FFT resampling (ops/resize.py) and the normalizers'
grid adaptation (ops/normalizers.py) against the JAX package's on the same
inputs: every resize, downsample and low-pass in 1D and 2D at odd and
even sizes, up and down, and UnitGaussianNormalizer.at_resolution at an
integer and at a non-integer ratio (where jax.image.resize anti-aliases).
f32 within 1e-4 relative (atol 1e-5 for values near zero).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from resolution_pde_tpu.ops import normalizers as jnorm  # noqa: E402
from resolution_pde_tpu.ops import resize as jresize  # noqa: E402
from resolution_pde_tpu_torch.ops import normalizers as tnorm  # noqa: E402
from resolution_pde_tpu_torch.ops import resize as tresize  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5


def _u(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _check(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n_in,n_out", [(16, 8), (15, 8), (16, 9), (9, 16),
                                        (8, 15), (12, 12)])
def test_resize_1d(n_in, n_out):
    u = _u((3, 2, n_in))
    _check(tresize.fft_resize_1d(torch.from_numpy(u), n_out),
           jresize.fft_resize_1d(u, n_out))


@pytest.mark.parametrize("n_in,n_out", [(16, 8), (15, 8), (16, 9), (9, 16),
                                        (8, 15), (7, 7), (16, (12, 20))])
def test_resize_2d(n_in, n_out):
    """The top and bottom band copies at odd and even sizes."""
    u = _u((2, 1, n_in, n_in))
    out = n_out if isinstance(n_out, tuple) else (n_out, n_out)
    _check(tresize.fft_resize_2d(torch.from_numpy(u), out),
           jresize.fft_resize_2d(u, out))


@pytest.mark.parametrize("n_in,n_out", [(32, 16), (31, 16), (32, 15),
                                        (17, 8)])
def test_downsample(n_in, n_out):
    u1, u2 = _u((2, n_in)), _u((2, 1, n_in, n_in), 1)
    _check(tresize.fft_downsample_1d(torch.from_numpy(u1), n_out),
           jresize.fft_downsample_1d(u1, n_out))
    _check(tresize.fft_downsample_2d(torch.from_numpy(u2), n_out),
           jresize.fft_downsample_2d(u2, n_out))


@pytest.mark.parametrize("n", [16, 15])
@pytest.mark.parametrize("cutoff", [0.25, 0.5, 1 / 3])
def test_lowpass(n, cutoff):
    u1, u2 = _u((3, n)), _u((2, 3, n, n), 1)
    _check(tresize.lowpass_filter_1d(torch.from_numpy(u1), cutoff),
           jresize.lowpass_filter_1d(u1, cutoff))
    _check(tresize.lowpass_filter_2d(torch.from_numpy(u2), cutoff),
           jresize.lowpass_filter_2d(u2, cutoff))


@pytest.mark.parametrize("grid", [(8, 8), (5, 5), (24, 24), (10, 14)])
def test_at_resolution(grid):
    """16 -> 8 strides; 16 -> 5 and 16 -> 10 x 14 downsample by a
    non-integer ratio (anti-aliased); 16 -> 24 upsamples."""
    x = _u((20, 1, 16, 16)) * 2 + 1
    want = jnorm.UnitGaussianNormalizer.fit(x).at_resolution(grid)
    got = tnorm.UnitGaussianNormalizer.fit(x).at_resolution(grid)
    _check(got.mean, want.mean)
    _check(got.std, want.std)
    z = _u((3, 1) + grid, 2)
    _check(got.encode(torch.from_numpy(z)), want.encode(z))
    assert got.eps == want.eps


def test_adapt_normalizer_and_minmax_denormalize():
    x = _u((6, 1, 8, 8))
    simple = tnorm.SimpleNormalizer.fit(x)
    assert tnorm.adapt_normalizer(simple, (4, 4)) is simple
    assert tnorm.adapt_normalizer(None, (4, 4)) is None
    ug = tnorm.UnitGaussianNormalizer.fit(x)
    assert tnorm.adapt_normalizer(ug, (8, 8)) is ug
    assert tnorm.adapt_normalizer(ug, (4, 4)).mean.shape == (1, 4, 4)
    z = _u((4,))
    _check(tnorm.minmax_denormalize(torch.from_numpy(z), -2.0, 3.0),
           jnorm.minmax_denormalize(z, -2.0, 3.0))
