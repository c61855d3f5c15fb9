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
