"""The port's small ops (grids, normalizers, losses) against the JAX
package, on the same inputs made with numpy."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from resolution_pde_tpu.ops import grids as jgrids  # noqa: E402
from resolution_pde_tpu.ops import losses as jlosses  # noqa: E402
from resolution_pde_tpu.ops import normalizers as jnorm  # noqa: E402
from resolution_pde_tpu_torch.ops import grids, losses, normalizers  # noqa: E402


@pytest.mark.parametrize("h,w", [(5, 7), (12, 16), (1, 3)])
def test_concat_grid_2d_matches_jax(h, w):
    x = np.random.default_rng(h).standard_normal((2, h, w, 3)).astype(
        np.float32)
    got = grids.concat_grid_2d(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jgrids.concat_grid_2d(
        jnp.asarray(x))))


@pytest.mark.parametrize("cls", ["SimpleNormalizer", "UnitGaussianNormalizer"])
def test_normalizers_match_jax(cls):
    x = np.random.default_rng(1).standard_normal((6, 3, 5)).astype(np.float32)
    tn = getattr(normalizers, cls).fit(torch.from_numpy(x))
    jn = getattr(jnorm, cls).fit(jnp.asarray(x))
    assert tn.eps == jn.eps
    for a, b in ((tn.mean, jn.mean), (tn.std, jn.std)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
    enc = tn.encode(torch.from_numpy(x))
    np.testing.assert_allclose(enc.numpy(),
                               np.asarray(jn.encode(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tn.decode(enc).numpy(), x, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("reduction", ["mean", "sum", None])
@pytest.mark.parametrize("weighted", [False, True])
def test_relative_l2_matches_jax(reduction, weighted):
    rng = np.random.default_rng(2)
    p, t = (rng.standard_normal((4, 2, 6)).astype(np.float32) for _ in range(2))
    w = np.array([1, 1, 0, 1], np.float32) if weighted else None
    got = losses.relative_l2(torch.from_numpy(p), torch.from_numpy(t),
                             reduction,
                             weights=None if w is None else torch.from_numpy(w))
    want = jlosses.relative_l2(jnp.asarray(p), jnp.asarray(t), reduction,
                               weights=None if w is None else jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    with pytest.raises(ValueError):
        losses.relative_l2(torch.from_numpy(p), torch.from_numpy(t), "avg")



@pytest.mark.parametrize("h,w,n_modes", [(128, 128, 64), (40, 24, 8),
                                         (16, 16, 9)])
def test_fft_spectral_conv_hands_irfft_real_edge_bins(monkeypatch, h, w,
                                                      n_modes):
    """The torch.fft path drops the imaginary part of the DC bin (and of
    an even n's Nyquist bin) itself before torch.fft.irfft, which on CUDA
    reads it at some shapes (n = 128 over thousands of rows) while numpy
    and the CPU ignore it. The result matches the JAX package's spectral conv."""
    from resolution_pde_tpu.ops.spectral import (
        factorized_spectral_conv_2d as jax_conv)
    from resolution_pde_tpu_torch.ops.spectral import (
        factorized_spectral_conv_2d)

    rng = np.random.default_rng(h + w)
    x = rng.standard_normal((2, h, w, 3)).astype(np.float32)
    wy, wx = (rng.standard_normal((3, 3, n_modes, 2)).astype(np.float32)
              for _ in range(2))
    edges = []
    irfft = torch.fft.irfft

    def spy(a, n=None, dim=-1, norm=None):
        m = a.shape[dim]
        idx = [0] + ([n // 2] if n % 2 == 0 and m > n // 2 else [])
        edges.append(float(a.imag.index_select(dim, torch.tensor(idx))
                           .abs().max()))
        return irfft(a, n=n, dim=dim, norm=norm)

    monkeypatch.setattr(torch.fft, "irfft", spy)
    got = factorized_spectral_conv_2d(
        torch.from_numpy(x), torch.from_numpy(wy), torch.from_numpy(wx),
        n_modes)
    assert edges == [0.0, 0.0]
    want = np.asarray(jax_conv(jnp.asarray(x), jnp.asarray(wy),
                               jnp.asarray(wx), n_modes))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("n,m", [(16, 9), (16, 5), (15, 8), (128, 64),
                                 (128, 70)])
def test_irfft_reads_edge_bins_as_numpy(n, m):
    """ops.spectral.irfft and irfft2 on spectra whose DC and Nyquist bins
    are not real agree with numpy's irfft and irfft2."""
    from resolution_pde_tpu_torch.ops.spectral import irfft, irfft2

    rng = np.random.default_rng(n + m)
    z = (rng.standard_normal((3, 5, m))
         + 1j * rng.standard_normal((3, 5, m))).astype(np.complex64)
    for norm in ("backward", "ortho"):
        np.testing.assert_allclose(
            irfft(torch.from_numpy(z), n, norm=norm).numpy(),
            np.fft.irfft(z, n, norm=norm), rtol=1e-4, atol=1e-5)
        got = irfft(torch.from_numpy(z).transpose(-1, -2), n, dim=-2,
                    norm=norm).transpose(-1, -2)
        np.testing.assert_allclose(got.numpy(), np.fft.irfft(z, n, norm=norm),
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        irfft2(torch.from_numpy(z), (6, n)).numpy(),
        np.fft.irfft2(z, (6, n)), rtol=1e-4, atol=1e-5)
