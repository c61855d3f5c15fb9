"""Port's FFNO1D against the JAX package's FFNO1D on the same weights
(carried over by utils.jax_bridge.ffno1d_state_dict): the outputs and
every parameter's gradient of a relative-L2 loss, in the 'full',
'low-pass' and 'no-fourier' modes, each with and without the grid channel
and through the dense FeedForward and the fused one (its plain version on
the CPU; JAX's Pallas kernel in interpret mode), at n = 32, 40 and 64
points with n_modes 24 (m = 17 and 21 keep the Nyquist bin at 32 and 40,
24 of 33 modes at 64; 'no-fourier' keeps no mode, so one size a case);
``factorized_spectral_conv_1d`` against JAX's directly; the bridge's round
trip through JAX's ``import_ffno1d``. JAX runs jitted, one program a
configuration and size.

f32 tolerance: relative L2 1e-4 for the outputs and each gradient, and
the FFNO2D tests' elementwise rtol 2e-4, atol 2e-5 on the outputs. Two
input channels: with one, the weight-normed lift's ``weight_v`` rows have
one element each, and its gradient is zero up to roundoff.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from resolution_pde_tpu.models import FFNO1D as JaxFFNO1D  # noqa: E402
from resolution_pde_tpu.ops.losses import relative_l2 as jax_rel_l2  # noqa: E402
from resolution_pde_tpu.ops.spectral import (  # noqa: E402
    factorized_spectral_conv_1d as jax_conv_1d)
from resolution_pde_tpu.utils.torch_import import import_ffno1d  # noqa: E402
from resolution_pde_tpu_torch.models import FFNO1D, get_model  # noqa: E402
from resolution_pde_tpu_torch.ops.losses import relative_l2  # noqa: E402
from resolution_pde_tpu_torch.ops.spectral import (  # noqa: E402
    factorized_spectral_conv_1d)
from resolution_pde_tpu_torch.utils.jax_bridge import ffno1d_state_dict  # noqa: E402

CFG = dict(in_channels=2, out_channels=1, width=8, n_layers=2, n_modes=24,
           factor=2, ff_weight_norm=True, n_ff_layers=3, layer_norm=True,
           dropout=0.0, activation="gelu")
SIZES = (32, 40, 64)
RTOL = 1e-4


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _data(n, seed=0, batch=2):
    rng = np.random.default_rng(seed + n)
    return (rng.standard_normal((batch, 2, n)).astype(np.float32),
            rng.standard_normal((batch, 1, n)).astype(np.float32))


@pytest.mark.parametrize("mode,use_grid,ff_impl,sizes", [
    ("full", False, "dense", SIZES),
    ("full", True, "fused", (32, 64)),
    ("low-pass", True, "dense", (32, 40)),
    ("low-pass", False, "fused", (64,)),
    ("no-fourier", True, "dense", (40,)),
    ("no-fourier", False, "fused", (32,)),
])
def test_ffno1d_and_gradients_match_jax(mode, use_grid, ff_impl, sizes):
    kw = dict(CFG, mode=mode, use_grid=use_grid, ff_impl=ff_impl)
    jmodel = JaxFFNO1D(**kw)
    params = jax.jit(jmodel.init)(jax.random.key(1),
                                  jnp.zeros((1, 2, SIZES[0])))
    model = FFNO1D(**kw)
    model.load_state_dict(ffno1d_state_dict(params))
    if mode == "full":
        assert model.fourier_layers[0].fourier_weight[0].shape == (8, 8, 24,
                                                                   2)
    else:
        assert not hasattr(model.fourier_layers[0], "fourier_weight")
    for n in sizes:
        x, y = _data(n)

        def loss(p):
            out = jmodel.apply({"params": p}, jnp.asarray(x))
            return jax_rel_l2(out, jnp.asarray(y)), out

        (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            params["params"])
        model.zero_grad()
        got = model(torch.from_numpy(x))
        relative_l2(got, torch.from_numpy(y)).backward()
        assert got.shape == (2, 1, n) and got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-5)
        assert _rel(got.detach().numpy(), want) <= RTOL
        want_g = ffno1d_state_dict(grads)
        got_g = {k: p.grad for k, p in model.named_parameters()}
        assert got_g.keys() == want_g.keys()
        for k, g in want_g.items():
            assert torch.isfinite(got_g[k]).all() and got_g[k].abs().sum() > 0
            assert _rel(got_g[k].numpy(), g.numpy()) <= RTOL, (n, k)


@pytest.mark.parametrize("n,n_modes", [(32, 24), (40, 24), (64, 33),
                                       (31, 24)])
def test_factorized_spectral_conv_1d_matches_jax(monkeypatch, n, n_modes):
    """The kept bins: m = min(n_modes, n // 2 + 1), the Nyquist bin among
    them at n = 32, 40 and 64 with 33 modes. torch.fft.irfft is handed
    real DC and Nyquist bins (cuFFT reads their imaginary parts at some
    shapes; numpy and JAX ignore them)."""
    rng = np.random.default_rng(n + n_modes)
    x = rng.standard_normal((3, n, 6)).astype(np.float32)
    w = (0.3 * rng.standard_normal((6, 6, n_modes, 2))).astype(np.float32)
    want = np.asarray(jax_conv_1d(jnp.asarray(x), jnp.asarray(w), n_modes))
    edges, irfft = [], torch.fft.irfft

    def spy(a, n=None, dim=-1, norm=None):
        m = a.shape[dim]
        idx = [0] + ([n // 2] if n % 2 == 0 and m > n // 2 else [])
        edges.append(float(a.imag.index_select(dim, torch.tensor(idx))
                           .abs().max()))
        return irfft(a, n=n, dim=dim, norm=norm)

    monkeypatch.setattr(torch.fft, "irfft", spy)
    got = factorized_spectral_conv_1d(torch.from_numpy(x),
                                      torch.from_numpy(w), n_modes).numpy()
    assert edges == [0.0]
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    assert _rel(got, want) <= RTOL


def test_bridge_round_trip_through_reference_importer():
    params = jax.jit(JaxFFNO1D(**CFG).init)(jax.random.key(2),
                                            jnp.zeros((1, 2, 32)))
    sd = {k: v.numpy() for k, v in ffno1d_state_dict(params).items()}
    back = import_ffno1d(sd, n_layers=CFG["n_layers"],
                         n_ff_layers=CFG["n_ff_layers"], layer_norm=True)
    flat_a = jax.tree_util.tree_leaves_with_path(params["params"])
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]),
                                      np.asarray(leaf), err_msg=str(path))


def test_ffno1d_registered_seeded_and_checked():
    assert get_model("FFNO1D") is FFNO1D
    assert get_model("models.ffno.FFNO1D") is FFNO1D
    a, b = (FFNO1D(**CFG, generator=torch.Generator().manual_seed(3))
            for _ in range(2))
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    with pytest.raises(ValueError, match="mode"):
        FFNO1D(**dict(CFG, mode="spectral"))
    with pytest.raises(ValueError, match="ff_impl"):
        FFNO1D(**CFG, ff_impl="pallas")
