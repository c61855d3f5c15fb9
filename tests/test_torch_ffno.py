"""Port's FFNO2D against the JAX package's FFNO2D with the same weights
(carried over by utils.jax_bridge), for every spectral_impl x ff_impl, on
non-square grids at two resolutions from one weight set; and the bridge's
round trip through the existing reference importer.

f32 tolerance rtol=2e-4, atol=2e-5: the tolerance of the existing
Pallas-vs-FFT tests. bf16: relative L2 2e-2, since bf16 rounds at
different places in the two frameworks.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from resolution_pde_tpu.models import FFNO2D as JaxFFNO2D  # noqa: E402
from resolution_pde_tpu.utils.torch_import import import_ffno2d  # noqa: E402
from resolution_pde_tpu_torch.models import FFNO2D, get_model  # noqa: E402
from resolution_pde_tpu_torch.utils.jax_bridge import ffno2d_state_dict  # noqa: E402

# n_modes 8: m = 7 (clipped, Nyquist) along H = 12, 8 along W = 16 and at 16x24
CFG = dict(in_channels=1, out_channels=1, width=6, n_layers=2, n_modes=8,
           factor=2, ff_weight_norm=True, n_ff_layers=2, layer_norm=True,
           dropout=0.0)
GRIDS = [(12, 16), (16, 24)]


@pytest.fixture(scope="module")
def jax_params():
    x = jnp.zeros((1, 1) + GRIDS[0], jnp.float32)
    return JaxFFNO2D(**CFG).init(jax.random.key(0), x)


def _x(grid, seed=0, batch=2):
    return np.random.default_rng(seed).standard_normal(
        (batch, 1) + grid).astype(np.float32)


def _port(params, **kw):
    model = FFNO2D(**CFG, **kw)
    model.load_state_dict(ffno2d_state_dict(params))
    return model.eval()


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("ff_impl", ["dense", "fused"])
@pytest.mark.parametrize("spectral_impl", ["fft", "pallas", "pallas2"])
def test_ffno2d_matches_jax(jax_params, spectral_impl, ff_impl, grid):
    x = _x(grid)
    want = np.asarray(JaxFFNO2D(**CFG, spectral_impl=spectral_impl,
                                ff_impl=ff_impl).apply(jax_params,
                                                       jnp.asarray(x)))
    with torch.no_grad():
        got = _port(jax_params, spectral_impl=spectral_impl,
                    ff_impl=ff_impl)(torch.from_numpy(x))
    assert got.shape == (2, 1) + grid and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


def test_ffno2d_bf16_matches_jax(jax_params):
    kw = dict(compute_dtype=jnp.bfloat16, spectral_impl="pallas2",
              ff_impl="fused", approx_gelu=True)
    x = _x(GRIDS[1], seed=1)
    want = np.asarray(JaxFFNO2D(**CFG, **kw).apply(jax_params, jnp.asarray(x)))
    kw["compute_dtype"] = torch.bfloat16
    with torch.no_grad():
        got = _port(jax_params, **kw)(torch.from_numpy(x))
    assert got.dtype == torch.float32  # cast back to the input's dtype
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel <= 2e-2


def test_ffno2d_wide_bf16_matches_jax():
    """FFNO2D at width 128 on 'pallas2' in bf16, 2 layers on a 32² grid:
    its spectral passes are too wide for the bf16 tensor-core kernel, so on
    the card they take the CUDA-core kernel with the bf16 rounding points;
    here the port's plain versions against the JAX model (Pallas kernels
    in interpret mode) on the same weights (relative L2 2e-2, as the
    narrow bf16 case)."""
    cfg = dict(CFG, width=128, n_modes=12, factor=4)
    kw = dict(compute_dtype=jnp.bfloat16, spectral_impl="pallas2",
              ff_impl="fused", approx_gelu=True)
    params = JaxFFNO2D(**cfg).init(jax.random.key(128),
                                   jnp.zeros((1, 1, 32, 32), jnp.float32))
    x = _x((32, 32), seed=3)
    want = np.asarray(JaxFFNO2D(**cfg, **kw).apply(params, jnp.asarray(x)))
    kw["compute_dtype"] = torch.bfloat16
    model = FFNO2D(**cfg, **kw)
    model.load_state_dict(ffno2d_state_dict(params))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert got.shape == (2, 1, 32, 32) and got.dtype == torch.float32
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel <= 2e-2


def test_bridge_round_trip_through_reference_importer(jax_params):
    """JAX params -> port state_dict -> the JAX package's import_ffno2d ->
    equal to the original params, bit for bit."""
    model = _port(jax_params)
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    back = import_ffno2d(sd, n_layers=CFG["n_layers"],
                         n_ff_layers=CFG["n_ff_layers"], layer_norm=True)
    orig = jax_params["params"]
    flat_back = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_orig = dict(jax.tree_util.tree_flatten_with_path(orig)[0])
    assert len(flat_back) == len(flat_orig)
    for path, leaf in flat_back:
        np.testing.assert_array_equal(leaf, np.asarray(flat_orig[path]))


def test_bridge_plain_projections():
    """Without ff_weight_norm the projections are plain linears."""
    cfg = dict(CFG, ff_weight_norm=False, layer_norm=False)
    params = JaxFFNO2D(**cfg).init(jax.random.key(1),
                                   jnp.zeros((1, 1, 8, 8), jnp.float32))
    model = FFNO2D(**cfg)
    model.load_state_dict(ffno2d_state_dict(params))  # strict: names match
    x = _x((8, 12), seed=2)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = np.asarray(JaxFFNO2D(**cfg).apply(params, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_port_init_is_seeded_and_registered():
    a = FFNO2D(**CFG, generator=torch.Generator().manual_seed(3))
    b = FFNO2D(**CFG, generator=torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    # weight norm starts at g = ||v||: the layer is the unnormalized one
    g = a.in_proj.weight_g
    assert torch.allclose(g, torch.linalg.vector_norm(a.in_proj.weight_v,
                                                      dim=1, keepdim=True))
    assert get_model("models.ffno.FFNO2D") is FFNO2D
    with pytest.raises(KeyError):
        get_model("FNO2d")


def test_unknown_impls_raise():
    with pytest.raises(ValueError, match="fft, pallas, pallas2"):
        FFNO2D(**CFG, spectral_impl="dft_v5")
    with pytest.raises(ValueError, match="ff_impl"):
        FFNO2D(**CFG, ff_impl="pallas")
