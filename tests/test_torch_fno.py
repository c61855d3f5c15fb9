"""Port's FNO1d and FNO2d against the JAX package's on the same weights
(carried over by utils.jax_bridge.fno1d_state_dict / fno2d_state_dict):
``spectral_conv_1d`` and ``spectral_conv_2d`` directly (a kept Nyquist
bin in 1D; in 2D the high corner, corners meeting with no rows between
them, and a kept Nyquist column, which the mix makes complex), their
ValueErrors, and the models' outputs and every parameter's gradient of a
relative-L2 loss at two resolutions each (width 8, 2 blocks). The bridge
round trip through JAX's ``import_fno1d`` / ``import_fno2d``.

f32 tolerance: relative L2 1e-4 for the outputs and each gradient.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from resolution_pde_tpu.models import FNO1d as JaxFNO1d  # noqa: E402
from resolution_pde_tpu.models import FNO2d as JaxFNO2d  # noqa: E402
from resolution_pde_tpu.ops import spectral as jspectral  # noqa: E402
from resolution_pde_tpu.ops.losses import relative_l2 as jax_rel_l2  # noqa: E402
from resolution_pde_tpu.utils.torch_import import (import_fno1d,  # noqa: E402
                                                   import_fno2d)
from resolution_pde_tpu_torch.models import FNO1d, FNO2d, get_model  # noqa: E402
from resolution_pde_tpu_torch.ops.losses import relative_l2  # noqa: E402
from resolution_pde_tpu_torch.ops.spectral import (spectral_conv_1d,  # noqa: E402
                                                   spectral_conv_2d)
from resolution_pde_tpu_torch.utils.jax_bridge import (  # noqa: E402
    fno1d_state_dict, fno2d_state_dict)

RTOL = 1e-4


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _rand(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("n,modes", [(32, 16), (30, 16), (64, 16), (9, 5)])
def test_spectral_conv_1d_matches_jax(n, modes):
    """16 of 17 bins at 32; all 16 at 30, the Nyquist bin among them; an
    odd length."""
    rng = np.random.default_rng(n)
    x, w = _rand(rng, (3, 4, n)), _rand(rng, (4, 5, modes, 2), 0.3)
    want = jspectral.spectral_conv_1d(jnp.asarray(x), jnp.asarray(w), modes)
    got = spectral_conv_1d(torch.from_numpy(x), torch.from_numpy(w), modes)
    assert got.shape == (3, 5, n)
    assert _rel(got, want) < RTOL


@pytest.mark.parametrize("h,w,m1,m2", [(16, 16, 4, 9), (16, 20, 8, 5),
                                       (12, 14, 3, 8)])
def test_spectral_conv_2d_matches_jax(h, w, m1, m2):
    """Both corners; 2 modes1 = H (no rows between them); a kept Nyquist
    column (modes2 = W // 2 + 1)."""
    rng = np.random.default_rng(h * w)
    x = _rand(rng, (2, 3, h, w))
    w1, w2 = (_rand(rng, (3, 4, m1, m2, 2), 0.3) for _ in range(2))
    want = jspectral.spectral_conv_2d(jnp.asarray(x), jnp.asarray(w1),
                                      jnp.asarray(w2), m1, m2)
    got = spectral_conv_2d(*map(torch.from_numpy, (x, w1, w2)), m1, m2)
    assert got.shape == (2, 4, h, w)
    assert _rel(got, want) < RTOL


def test_spectral_convs_refuse_too_many_modes():
    x1 = torch.zeros(1, 2, 30)
    with pytest.raises(ValueError, match="exceeds available frequencies 16"):
        spectral_conv_1d(x1, torch.zeros(2, 2, 17, 2), 17)
    x2 = torch.zeros(1, 2, 16, 16)
    for m1, m2 in ((9, 4), (4, 10)):
        w = torch.zeros(2, 2, m1, m2, 2)
        with pytest.raises(ValueError, match=r"exceed spectrum \(8,9\)"):
            spectral_conv_2d(x2, w, w, m1, m2)
        with pytest.raises(ValueError):
            jspectral.spectral_conv_2d(jnp.zeros((1, 2, 16, 16)),
                                       jnp.asarray(w.numpy()),
                                       jnp.asarray(w.numpy()), m1, m2)


CASES = {
    "1d": (JaxFNO1d, FNO1d, fno1d_state_dict, import_fno1d,
           dict(in_channels=2, out_channels=1, modes=6, width=8,
                n_blocks=2), (32, 64)),
    "2d": (JaxFNO2d, FNO2d, fno2d_state_dict, import_fno2d,
           dict(in_channels=2, out_channels=1, modes1=4, modes2=5, width=8,
                n_blocks=2), (16, 24)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fno_and_gradients_match_jax(case):
    jcls, cls, bridge, importer, kw, sizes = CASES[case]
    jmodel = jcls(**kw)
    ndim = int(case[0])
    shape = lambda n: (2, 2) + (n,) * ndim  # noqa: E731
    params = jax.jit(jmodel.init)(jax.random.key(1),
                                  jnp.zeros(shape(sizes[0])))["params"]
    model = cls(**kw)
    sd = bridge(params)
    assert sorted(sd) == sorted(model.state_dict())
    model.load_state_dict(sd)
    # the port's names are the reference's: JAX's importer reads them back
    back = importer({k: v.numpy() for k, v in model.state_dict().items()},
                    n_blocks=kw["n_blocks"])
    jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                           jax.tree_util.tree_map(np.asarray, params))
    for n in sizes:
        rng = np.random.default_rng(n)
        x = rng.standard_normal(shape(n)).astype(np.float32)
        y = rng.standard_normal((2, 1) + (n,) * ndim).astype(np.float32)

        def loss(p):
            out = jmodel.apply({"params": p}, jnp.asarray(x))
            return jax_rel_l2(out, jnp.asarray(y)), out

        (_, want), grads = jax.jit(jax.value_and_grad(loss,
                                                      has_aux=True))(params)
        model.zero_grad()
        out = model(torch.from_numpy(x))
        relative_l2(out, torch.from_numpy(y)).backward()
        assert out.shape == (2, 1) + (n,) * ndim
        assert _rel(out.detach(), want) < RTOL
        gsd = bridge(grads)
        for name, p in model.named_parameters():
            assert _rel(p.grad, gsd[name]) < RTOL, (case, n, name)


def test_fno_init_registry_and_seed():
    a = FNO2d(1, 1, 4, 4, 8, n_blocks=2,
              generator=torch.Generator().manual_seed(3))
    b = FNO2d(1, 1, 4, 4, 8, n_blocks=2,
              generator=torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    w = a.fno_blocks[0].spectral_conv.weights1.detach()
    assert w.shape == (8, 8, 4, 4, 2)
    assert float(w.min()) >= 0.0 and float(w.max()) < 1.0 / 64
    assert float(w.mean()) > 0.25 / 64
    assert get_model("models.fno.FNO1d") is FNO1d
    assert get_model("FNO2d") is FNO2d
    with pytest.raises(ValueError, match="activation"):
        FNO1d(1, 1, 4, 8, activation="swish")
