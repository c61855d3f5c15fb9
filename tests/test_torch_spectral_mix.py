"""Port's spectral axis pass (plain version of the CUDA kernel), its packed
weight and DFT factors, and the port's factorized spectral convs, against
the JAX package (Pallas kernels in interpret mode on the CPU), on the same
inputs made with numpy.

f32 tolerance rtol=2e-4, atol=2e-5: the tolerance of the existing
Pallas-vs-FFT tests; only the order of f32 sums differs. bf16: relative L2
2e-2, since bf16 rounds at different places in the two frameworks.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from resolution_pde_tpu.ops import spectral as jspec  # noqa: E402
from resolution_pde_tpu.ops.pallas import spectral_mix as jmix  # noqa: E402
from resolution_pde_tpu.ops.pallas import spectral_mix2 as jmix2  # noqa: E402
from resolution_pde_tpu_torch.ops import spectral as tspec  # noqa: E402
from resolution_pde_tpu_torch.ops.kernels import spectral_mix as tmix  # noqa: E402

F32 = dict(rtol=2e-4, atol=2e-5)

# (n, n_modes): m = min(n_modes, n // 2 + 1)
MODE_CASES = [
    (16, 5),    # odd m
    (16, 12),   # m clipped to n//2+1 = 9 with n even: Nyquist weight 1
    (12, 7),    # m == n//2+1 exactly, even n
    (15, 6),    # odd n
    (15, 10),   # odd n, clipped to 8: no Nyquist bin
]


def _weight(rng, c, o, modes):
    return (rng.standard_normal((c, o, modes, 2)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("n,m", [(16, 5), (16, 9), (12, 7), (15, 8), (24, 13),
                                 (7, 4)])
@pytest.mark.parametrize("norm", ["ortho", "backward"])
def test_dft_matrices_bit_exact(n, m, norm):
    for a, b in zip(tspec._dft_matrices(n, m, norm),
                    jspec._dft_matrices(n, m, norm)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("m", [3, 5, 8])
def test_pack_mix_weight_bit_exact(m):
    w = _weight(np.random.default_rng(m), 4, 3, 8)
    got = tmix.pack_mix_weight(torch.from_numpy(w), m).numpy()
    want = np.asarray(jmix2.pack_mix_weight(jnp.asarray(w), m))
    assert got.shape == (m, 8, 6)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,n_modes", MODE_CASES)
def test_spectral_pass_reference_matches_jax_kernels(n, n_modes):
    rng = np.random.default_rng(n * 100 + n_modes)
    c, o, rows = 4, 3, 5
    x = rng.standard_normal((rows, n, c)).astype(np.float32)
    w = _weight(rng, c, o, n_modes)
    m = min(n_modes, n // 2 + 1)
    f2, i2 = tmix.packed_factors(n, m, "ortho", torch.device("cpu"))
    got = tmix.spectral_pass_reference(
        torch.from_numpy(x), f2, i2, tmix.pack_mix_weight(torch.from_numpy(w), m),
        torch.float32).numpy()
    packed = np.asarray(jmix2.packed_spectral_mix_1d(
        jnp.asarray(x), jnp.asarray(w), n_modes, interpret=True,
        compute_dtype=jnp.float32))
    unpacked = np.asarray(jmix.truncated_spectral_mix_1d(
        jnp.asarray(x), jnp.asarray(w), n_modes, interpret=True))
    assert got.shape == (rows, n, o)
    np.testing.assert_allclose(got, packed, **F32)
    np.testing.assert_allclose(got, unpacked, **F32)


def _conv_inputs(seed, b=2, h=12, w=16, c=4, modes=6):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, w, c)).astype(np.float32),
            _weight(rng, c, c, modes), _weight(rng, c, c, modes), modes)


@pytest.mark.parametrize("h,w,modes", [(12, 16, 6), (16, 24, 5), (10, 7, 9)])
def test_factorized_convs_match_jax(h, w, modes):
    """Non-square grids with a different m per axis: a swap of weight_y
    (along W) and weight_x (along H) fails here."""
    x, wy, wx, modes = _conv_inputs(h * w, h=h, w=w, modes=modes)
    jx, jwy, jwx = jnp.asarray(x), jnp.asarray(wy), jnp.asarray(wx)
    tx, twy, twx = (torch.from_numpy(a) for a in (x, wy, wx))
    want = np.asarray(jspec.factorized_spectral_conv_2d(jx, jwy, jwx, modes))
    np.testing.assert_allclose(
        tspec.factorized_spectral_conv_2d(tx, twy, twx, modes).numpy(),
        want, **F32)
    np.testing.assert_allclose(
        tspec.factorized_spectral_conv_2d_pallas(tx, twy, twx, modes).numpy(),
        np.asarray(jspec.factorized_spectral_conv_2d_pallas(
            jx, jwy, jwx, modes, interpret=True)), **F32)
    np.testing.assert_allclose(
        tmix.factorized_spectral_conv_2d_pallas2(
            tx, twy, twx, modes, compute_dtype=torch.float32).numpy(),
        np.asarray(jmix2.factorized_spectral_conv_2d_pallas2(
            jx, jwy, jwx, modes, compute_dtype=jnp.float32,
            interpret=True)), **F32)
    # and the fused path is the FFT path
    np.testing.assert_allclose(
        tspec.factorized_spectral_conv_2d_pallas(tx, twy, twx, modes).numpy(),
        want, **F32)


def test_factorized_conv_pallas2_bf16_matches_jax():
    x, wy, wx, modes = _conv_inputs(7, h=16, w=24, modes=9)
    want = np.asarray(jmix2.factorized_spectral_conv_2d_pallas2(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(wy), jnp.asarray(wx),
        modes, compute_dtype=jnp.bfloat16, interpret=True).astype(jnp.float32))
    got = tmix.factorized_spectral_conv_2d_pallas2(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(wy),
        torch.from_numpy(wx), modes, compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    rel = np.linalg.norm(got.float().numpy() - want) / np.linalg.norm(want)
    assert rel <= 2e-2


def test_axis_pass_accumulates_in_place():
    x, wy, _, modes = _conv_inputs(3)
    tx = torch.from_numpy(x)
    m = min(modes, x.shape[2] // 2 + 1)
    f2, i2 = tmix.packed_factors(x.shape[2], m, "ortho", tx.device)
    wpk = tmix.pack_mix_weight(torch.from_numpy(wy), m)
    once = tmix.spectral_axis_pass(tx, f2, i2, wpk, 2, torch.float32)
    acc = torch.ones_like(once)
    out = tmix.spectral_axis_pass(tx, f2, i2, wpk, 2, torch.float32, acc=acc)
    assert out is acc
    np.testing.assert_array_equal(out.numpy(), (once + 1).numpy())
    with pytest.raises(ValueError):
        tmix.spectral_axis_pass(tx, f2, i2, wpk, 3, torch.float32)
