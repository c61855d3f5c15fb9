"""The port's S4 serving slice on the CPU against the JAX package: the two
kernel layers through both ``kernel_impl`` routes on bridged parameters,
the ``jnp`` route across the kernel option surface, FFTConv, S4Block and
S4D, S4Model in both modes, the port's ServingEngine against the JAX one
on the same weights, the pallas route's refusals, and its forward-only
backward.

Tolerances, as relative L2: 1e-5 for a layer where both sides run the same
f32 formulation (only transcendental functions' last bits, FFT
implementations and sum orders differ, about 1e-6 measured); 1e-4 at the
model level, across routes and for gradients, the slice criterion of
ROADMAP.md (errors pass through several FFT convolutions and Dense
layers, and the two routes place dt differently in the DPLR kernel).
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from resolution_pde_tpu.deploy import ServingEngine as JaxEngine  # noqa: E402
from resolution_pde_tpu.models import s4 as js4  # noqa: E402
from resolution_pde_tpu.ops.grids import concat_grid_1d as jax_grid_1d  # noqa: E402
from resolution_pde_tpu.ops.normalizers import (  # noqa: E402
    SimpleNormalizer as JaxNorm)
from resolution_pde_tpu_torch.deploy import ServingEngine  # noqa: E402
from resolution_pde_tpu_torch.models import get_model, s4  # noqa: E402
from resolution_pde_tpu_torch.ops.grids import concat_grid_1d  # noqa: E402
from resolution_pde_tpu_torch.ops.normalizers import SimpleNormalizer  # noqa: E402
from resolution_pde_tpu_torch.utils.jax_bridge import (  # noqa: E402
    fftconv_state_dict, s4_block_state_dict, s4_model_state_dict)

SAME = 1e-5   # a layer, same f32 formulation on both sides
MODEL = 1e-4  # the model level, across routes, gradients
D, N, L, B = 8, 16, 32, 3


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _kernel_sd(params) -> dict:
    return {k: torch.from_numpy(np.array(v))
            for k, v in params["params"].items()}


def _kernel_pair(cls_name, L_, **kw):
    """A JAX kernel layer, its output at L_, and the port's layer holding
    the same parameters."""
    jl = getattr(js4, cls_name)(**kw)
    params = jl.init(jax.random.key(1), L_)
    want = np.asarray(jl.apply(params, L_))
    layer = getattr(s4, cls_name)(**kw)
    layer.load_state_dict(_kernel_sd(params))
    return layer, want


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("cls_name,d_state", [("DPLRKernelLayer", N),
                                              ("S4DKernelLayer", N)])
def test_kernel_layers_match_jax(cls_name, d_state, impl):
    """Both routes on bridged parameters, 2 kernel channels (one launch
    folds them on the pallas route), L 48."""
    layer, want = _kernel_pair(cls_name, 48, d_model=D, d_state=d_state,
                               channels=2, kernel_impl=impl)
    with torch.no_grad():
        got = layer(48).numpy()
    assert got.shape == want.shape == (2, D, 48)
    assert rel_l2(got, want) <= SAME


S4D_OPTIONS = [
    dict(disc="bilinear"), dict(disc="dss"), dict(measure="inv"),
    dict(measure="legs"), dict(measure="diag", n_ssm=2), dict(n_ssm=2),
    dict(dt_tie=False), dict(dt_fast=True), dict(dt_transform="softplus"),
    dict(real_transform="softplus"), dict(imag_transform="exp"),
    dict(bandlimit=0.05), dict(is_real=True),
    dict(disc="bilinear", dt_transform="sigmoid", dt_fast=True),
]
DPLR_OPTIONS = [
    dict(measure="legt", rank=2), dict(measure="fourier"),
    dict(measure="hippo", n_ssm=2), dict(rank=2), dict(n_ssm=2),
    dict(dt_tie=False), dict(dt_transform="softplus", dt_fast=True),
    dict(real_transform="softplus"), dict(bandlimit=0.05),
]


def _ids(o):
    return "-".join(f"{k}={v}" for k, v in o.items())


@pytest.mark.parametrize(
    "cls_name,opts",
    [("S4DKernelLayer", o) for o in S4D_OPTIONS]
    + [("DPLRKernelLayer", o) for o in DPLR_OPTIONS],
    ids=lambda a: a if isinstance(a, str) else _ids(a))
def test_jnp_route_option_surface_matches_jax(cls_name, opts):
    layer, want = _kernel_pair(cls_name, L, d_model=4, d_state=8,
                               channels=1, **opts)
    with torch.no_grad():
        got = layer(L).numpy()
    assert np.isfinite(got).all()
    assert rel_l2(got, want) <= SAME


@pytest.mark.parametrize("mode", ["dplr", "diag"])
def test_fftconv_bidirectional_matches_jax(rng, mode):
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    jl = js4.FFTConvLayer(D, N, mode, bidirectional=True)
    params = jax.jit(jl.init)(jax.random.key(2), jnp.asarray(x))
    want = np.asarray(jax.jit(jl.apply)(params, jnp.asarray(x)))
    layer = s4.FFTConvLayer(D, N, mode, bidirectional=True).eval()
    layer.load_state_dict(fftconv_state_dict(params["params"]))
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
    assert got.shape == (B, L, D)
    assert rel_l2(got, want) <= SAME


@pytest.mark.parametrize("kw", [
    dict(mode="dplr", gate=2, gate_act="gelu", bottleneck=2,
         mult_act="tanh"),
    dict(mode="diag", gate=1, final_act="relu"),
    dict(mode="diag", final_act=None, kernel_impl="pallas"),
], ids=["gate2-bottleneck", "gate1-relu", "no-final-pallas"])
def test_s4block_matches_jax(rng, kw):
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    jb = js4.S4Block(D, N, **kw)
    params = jax.jit(jb.init)(jax.random.key(3), jnp.asarray(x))
    want = np.asarray(jax.jit(jb.apply)(params, jnp.asarray(x)))
    block = s4.S4Block(D, N, **kw).eval()
    block.load_state_dict(s4_block_state_dict(params["params"]))
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    assert rel_l2(got, want) <= SAME


def test_s4d_layer_and_grid_match_jax(rng):
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    jm = js4.S4D(D, N)
    params = jax.jit(jm.init)(jax.random.key(4), jnp.asarray(x))
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    layer = s4.S4D(D, N).eval()
    layer.load_state_dict(s4_block_state_dict(params["params"]))
    with torch.no_grad():
        assert rel_l2(layer(torch.from_numpy(x)).numpy(), want) <= SAME
    np.testing.assert_array_equal(
        concat_grid_1d(torch.from_numpy(x)).numpy(),
        np.asarray(jax_grid_1d(jnp.asarray(x))))


@functools.cache
def _jax_model(mode, d_input=4, prenorm=False, seed=0):
    """A JAX S4Model, its variables and its jitted apply (shared between
    the tests of both routes, so each shape compiles once)."""
    jm = js4.S4Model(d_input=d_input, d_output=1, d_model=D, n_layers=2,
                     dropout=0.2, prenorm=prenorm, mode=mode)
    x0 = jnp.zeros((1, d_input, L), jnp.float32)
    return jm, jax.jit(jm.init)(jax.random.key(seed), x0), jax.jit(jm.apply)


def _port_model(mode, variables, impl, d_input=4, prenorm=False):
    model = s4.S4Model(d_input=d_input, d_output=1, d_model=D, n_layers=2,
                       dropout=0.2, prenorm=prenorm, mode=mode,
                       kernel_impl=impl)
    model.load_state_dict(s4_model_state_dict(variables))
    return model


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("mode,prenorm", [("dplr", False), ("diag", False),
                                          ("dplr", True)])
def test_s4model_matches_jax(rng, mode, prenorm, impl):
    """S4Model on weights bridged from the JAX S4Model (whose blocks take
    the jnp route), through both of the port's routes, at L 32 and 48."""
    _, variables, apply = _jax_model(mode, prenorm=prenorm)
    model = _port_model(mode, variables, impl, prenorm=prenorm).eval()
    for length in (L, 48):
        x = rng.standard_normal((B, 4, length)).astype(np.float32)
        want = np.asarray(apply(variables, jnp.asarray(x)))
        with torch.no_grad():
            got = model(torch.from_numpy(x)).numpy()
        assert got.shape == (B, 1, length)
        assert rel_l2(got, want) <= MODEL


@pytest.mark.parametrize("mode", ["dplr", "diag"])
def test_serving_engine_matches_jax(rng, mode):
    """The port's ServingEngine (on the CPU, pallas route) against the JAX
    ServingEngine on the same weights and normalizers: buckets of 4 at
    L 32 and 48, requests of 3 (pad-and-slice)."""
    jm, variables, _ = _jax_model(mode, d_input=3, seed=5)
    stats = dict(x=(0.3, 1.7), y=(-0.2, 2.1))
    jeng = JaxEngine(jm, variables,
                     x_normalizer=JaxNorm(*map(np.float32, stats["x"])),
                     y_normalizer=JaxNorm(*map(np.float32, stats["y"])))
    teng = ServingEngine(_port_model(mode, variables, "pallas", d_input=3),
                         x_normalizer=SimpleNormalizer(*stats["x"]),
                         y_normalizer=SimpleNormalizer(*stats["y"]),
                         device="cpu")
    for eng in (jeng, teng):
        eng.warmup(spatial_shapes=[L, 48], batch_sizes=[4], in_channels=3)
    assert teng.buckets() == [("predict", (L,), 3, 4), ("predict", (48,), 3,
                                                         4)]
    for length in (L, 48):
        x = rng.standard_normal((3, 3, length)).astype(np.float32)
        got = teng.predict(x)
        assert got.shape == (3, 1, length) and got.dtype == np.float32
        assert rel_l2(got, jeng.predict(x)) <= MODEL


@pytest.mark.parametrize("cls_name,opts", [
    ("S4DKernelLayer", dict(disc="bilinear")),
    ("S4DKernelLayer", dict(dt_tie=False)),
    ("S4DKernelLayer", dict(dt_transform="softplus")),
    ("S4DKernelLayer", dict(dt_fast=True)),
    ("S4DKernelLayer", dict(is_real=True)),
    ("DPLRKernelLayer", dict(rank=2)),
    ("DPLRKernelLayer", dict(dt_tie=False)),
    ("DPLRKernelLayer", dict(dt_fast=True)),
], ids=lambda a: a if isinstance(a, str) else _ids(a))
def test_pallas_route_refuses_what_jax_refuses(cls_name, opts):
    kw = dict(d_model=4, d_state=8, kernel_impl="pallas", **opts)
    with pytest.raises(ValueError) as jax_err:
        getattr(js4, cls_name)(**kw).init(jax.random.key(0), 16)
    with pytest.raises(ValueError) as port_err:
        getattr(s4, cls_name)(**kw)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("mode", ["dplr", "diag"])
def test_backward_raises_on_pallas_and_matches_jax_on_jnp(rng, mode):
    """backward() through the pallas route raises (the kernels are
    forward-only, as in the JAX package); through the jnp route every
    parameter's gradient matches jax.grad of the JAX S4Model."""
    jm, variables, _ = _jax_model(mode, seed=6)
    x = rng.standard_normal((B, 4, L)).astype(np.float32)
    model = _port_model(mode, variables, "pallas").eval()
    with pytest.raises(NotImplementedError, match="forward-only"):
        model(torch.from_numpy(x)).square().mean().backward()

    jgrads = jax.jit(jax.grad(lambda p: jnp.mean(jnp.square(
        jm.apply({"params": p}, jnp.asarray(x))))))(variables["params"])
    want = s4_model_state_dict(jgrads)
    model = _port_model(mode, variables, "jnp").eval()
    model(torch.from_numpy(x)).square().mean().backward()
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    flat = [(got[k].grad.numpy().ravel(), want[k].numpy().ravel())
            for k in sorted(want)]
    assert all(np.isfinite(g).all() for g, _ in flat)
    assert rel_l2(np.concatenate([g for g, _ in flat]),
                  np.concatenate([w for _, w in flat])) <= MODEL


def test_registry_names_the_s4_models():
    assert get_model("S4Model") is get_model("models.s4_1d.S4Model") \
        is s4.S4Model
    assert get_model("models.s4d.S4D") is get_model("S4D") is s4.S4D
    assert get_model("S4Block") is s4.S4Block


def test_s4model_draws_from_the_generator():
    kw = dict(d_input=2, d_model=D, n_layers=1, mode="diag")
    a, b, c = (s4.S4Model(**kw, generator=torch.Generator().manual_seed(s))
               for s in (0, 0, 1))
    sa, sb, sc = (m.state_dict() for m in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["s4_layers.0.layer.kernel.C"],
                           sc["s4_layers.0.layer.kernel.C"])
    with pytest.raises(ValueError, match="kernel_impl"):
        s4.S4Model(**kw, kernel_impl="triton")
