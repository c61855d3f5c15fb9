"""Port's ServingEngine against the JAX package's ServingEngine: the same
FFNO2D weights (carried over by utils.jax_bridge) and the same normalizer
statistics, on the slice's path (spectral_impl 'pallas2', ff_impl 'fused'),
in f32 on a non-square grid.

Tolerance rtol=2e-4, atol=2e-5: the f32 tolerance of the existing
Pallas-vs-FFT tests.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from resolution_pde_tpu.deploy import ServingEngine as JaxEngine  # noqa: E402
from resolution_pde_tpu.models import FFNO2D as JaxFFNO2D  # noqa: E402
from resolution_pde_tpu.ops.normalizers import (  # noqa: E402
    SimpleNormalizer as JaxNorm)
from resolution_pde_tpu_torch.deploy import ServingEngine  # noqa: E402
from resolution_pde_tpu_torch.models import FFNO2D  # noqa: E402
from resolution_pde_tpu_torch.ops.normalizers import SimpleNormalizer  # noqa: E402
from resolution_pde_tpu_torch.utils.jax_bridge import ffno2d_state_dict  # noqa: E402

CFG = dict(in_channels=1, out_channels=1, width=6, n_layers=2, n_modes=5,
           factor=2, ff_weight_norm=True, n_ff_layers=2, layer_norm=True,
           dropout=0.0, spectral_impl="pallas2", ff_impl="fused")
GRID = (12, 16)
STATS = dict(x=(0.3, 1.7), y=(-0.2, 2.1))
TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module")
def engines():
    jm = JaxFFNO2D(**CFG)
    variables = jm.init(jax.random.key(0), jnp.zeros((1, 1) + GRID))
    jeng = JaxEngine(jm, variables,
                     x_normalizer=JaxNorm(np.float32(STATS["x"][0]),
                                          np.float32(STATS["x"][1])),
                     y_normalizer=JaxNorm(np.float32(STATS["y"][0]),
                                          np.float32(STATS["y"][1])))
    model = FFNO2D(**CFG)
    model.load_state_dict(ffno2d_state_dict(variables))
    teng = ServingEngine(model, x_normalizer=SimpleNormalizer(*STATS["x"]),
                         y_normalizer=SimpleNormalizer(*STATS["y"]),
                         device="cpu")
    for eng in (jeng, teng):
        eng.warmup(spatial_shapes=[GRID], batch_sizes=[4], rollout_steps=[3])
    return jeng, teng


def test_predict_pads_and_slices_like_jax(engines):
    jeng, teng = engines
    x = np.random.default_rng(0).standard_normal((3, 1) + GRID).astype(
        np.float32)
    got = teng.predict(x)  # batch 3 on the warmed bucket of 4
    assert got.shape == (3, 1) + GRID and got.dtype == np.float32
    np.testing.assert_allclose(got, jeng.predict(x), **TOL)
    assert teng.buckets() == [("forecast", GRID, 1, 4, 3),
                              ("predict", GRID, 1, 4)]
    padded = teng.predict_device(x)
    assert padded.shape == (4, 1) + GRID
    np.testing.assert_array_equal(padded[:3].numpy(), got)


def test_forecast_matches_jax(engines):
    jeng, teng = engines
    x0 = np.random.default_rng(1).standard_normal((2, 1) + GRID).astype(
        np.float32)
    got = teng.forecast(x0, 3)
    assert got.shape == (2, 3, 1) + GRID
    np.testing.assert_allclose(got, jeng.forecast(x0, 3), **TOL)


def test_strict_buckets_raise_on_a_miss():
    teng = ServingEngine(FFNO2D(**CFG), strict_buckets=True,
                         device="cpu")
    teng.warmup(spatial_shapes=[GRID], batch_sizes=[2])
    x = np.zeros((3, 1) + GRID, np.float32)
    with pytest.raises(LookupError):
        teng.predict(x)
    with pytest.raises(LookupError):
        teng.forecast(x[:2], 2)


def test_bucket_miss_warms_on_demand():
    teng = ServingEngine(FFNO2D(**CFG), device="cpu")
    x = np.zeros((2, 1, 8, 8), np.float32)
    with pytest.warns(RuntimeWarning, match="bucket miss"):
        out = teng.predict(x)
    assert out.shape == x.shape
    assert ("predict", (8, 8), 1, 2) in teng.buckets()

