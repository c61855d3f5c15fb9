"""Port's fused FeedForward (plain version of the CUDA kernel) against the
JAX package's Pallas kernel (interpret mode on the CPU), on the same inputs
made with numpy.

f32 tolerance rtol=2e-4, atol=2e-5: the tolerance of the existing
Pallas-vs-FFT tests; only the order of f32 sums differs.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from resolution_pde_tpu.ops.pallas.fused_ff import fused_feedforward  # noqa: E402
from resolution_pde_tpu_torch.ops.kernels import fused_ff  # noqa: E402

DIM, FACTOR = 8, 2


def _inputs(n_layers, rows, has_ln, has_res, seed=0):
    rng = np.random.default_rng(seed)
    dims = [DIM] + [DIM * FACTOR] * (n_layers - 1) + [DIM]
    ks = [(rng.standard_normal((dims[i], dims[i + 1])) * 0.4).astype(np.float32)
          for i in range(n_layers)]
    bs = [(rng.standard_normal(dims[i + 1]) * 0.1).astype(np.float32)
          for i in range(n_layers)]
    ln = ((1.0 + 0.1 * rng.standard_normal(DIM)).astype(np.float32),
          (0.1 * rng.standard_normal(DIM)).astype(np.float32)) if has_ln else None
    x = rng.standard_normal((3, rows, DIM)).astype(np.float32)
    res = rng.standard_normal((3, rows, DIM)).astype(np.float32) if has_res else None
    return x, ks, bs, ln, res


def _jax(x, ks, bs, ln, res, approx):
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    return np.asarray(fused_feedforward(
        j(x), [j(k) for k in ks], [j(b) for b in bs],
        None if ln is None else tuple(j(a) for a in ln), j(res),
        approx_gelu=approx, compute_dtype=jnp.float32, interpret=True))


def _torch(x, ks, bs, ln, res, approx, dtype=torch.float32):
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    return fused_ff.fused_feedforward(
        t(x), [t(k) for k in ks], [t(b) for b in bs],
        None if ln is None else tuple(t(a) for a in ln), t(res),
        approx_gelu=approx, compute_dtype=dtype)


@pytest.mark.parametrize("n_layers", [1, 3])
@pytest.mark.parametrize("has_ln", [True, False])
@pytest.mark.parametrize("approx", [True, False])
@pytest.mark.parametrize("has_res", [True, False])
def test_fused_ff_reference_matches_jax(n_layers, has_ln, approx, has_res):
    # 3 x 37 = 111 rows: a multiple of no row tile of either kernel
    x, ks, bs, ln, res = _inputs(n_layers, 37, has_ln, has_res)
    want = _jax(x, ks, bs, ln, res, approx)
    got = _torch(x, ks, bs, ln, res, approx)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


def test_fused_ff_bf16_reference_matches_jax():
    """bf16 compute: both round the hidden activations to bf16 at the same
    points, so they differ by rounding flips only (bound: relative L2 2e-2)."""
    x, ks, bs, ln, res = _inputs(3, 37, True, True, seed=1)
    j = lambda a: jnp.asarray(a)  # noqa: E731
    want = np.asarray(fused_feedforward(
        j(x).astype(jnp.bfloat16), [j(k) for k in ks], [j(b) for b in bs],
        tuple(j(a) for a in ln), j(res).astype(jnp.bfloat16),
        approx_gelu=True, compute_dtype=jnp.bfloat16,
        interpret=True).astype(jnp.float32))
    t = torch.from_numpy
    got = fused_ff.fused_feedforward(
        t(x).bfloat16(), [t(k) for k in ks], [t(b) for b in bs],
        tuple(t(a) for a in ln), t(res).bfloat16(), approx_gelu=True,
        compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    rel = np.linalg.norm(got.float().numpy() - want) / np.linalg.norm(want)
    assert rel <= 2e-2


def test_fused_ff_save_acts_raises():
    x, ks, bs, ln, res = _inputs(2, 4, False, False)
    with pytest.raises(NotImplementedError):
        fused_ff.fused_feedforward(torch.from_numpy(x),
                                   [torch.from_numpy(k) for k in ks],
                                   [torch.from_numpy(b) for b in bs],
                                   save_acts=True)
