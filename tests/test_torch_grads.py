"""Gradients of the port against the JAX package, on the same inputs made
with numpy: the plain backward of the fused FeedForward (K1b) and of the
spectral passes (the K2/K3 adjoints and the packed weight's gradient)
against ``jax.vjp`` of the JAX kernels (Pallas in interpret mode on the
CPU), and FFNO2D's parameter gradients against ``jax.grad`` through the
bridge.

Tolerances: f32 rtol=2e-4, atol=2e-5 where elements are compared (the
Pallas-vs-FFT tolerance of the existing tests; only the order of f32 sums
differs), relative L2 1e-4 for whole f32 gradients; bf16 relative L2 1e-2
per tensor, since bf16 rounds at different places in the two frameworks.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from resolution_pde_tpu.models import FFNO2D as JaxFFNO2D  # noqa: E402
from resolution_pde_tpu.ops.losses import relative_l2 as jax_rel_l2  # noqa: E402
from resolution_pde_tpu.ops.pallas import spectral_mix as jmix  # noqa: E402
from resolution_pde_tpu.ops.pallas import spectral_mix2 as jmix2  # noqa: E402
from resolution_pde_tpu.ops.pallas.fused_ff import (  # noqa: E402
    fused_feedforward as jax_fused_ff)
from resolution_pde_tpu_torch.models import FFNO2D  # noqa: E402
from resolution_pde_tpu_torch.ops.kernels import fused_ff  # noqa: E402
from resolution_pde_tpu_torch.ops.kernels import spectral_mix as tmix  # noqa: E402
from resolution_pde_tpu_torch.ops.losses import relative_l2  # noqa: E402
from resolution_pde_tpu_torch.utils.jax_bridge import ffno2d_state_dict  # noqa: E402
from test_torch_spectral_mix import _plain_pass_f32_operands  # noqa: E402

F32 = dict(rtol=2e-4, atol=2e-5)
DIM, FACTOR = 8, 2


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _ff_inputs(n_layers, has_ln, has_res, seed, dims=None):
    rng = np.random.default_rng(seed)
    dims = dims or [DIM] + [DIM * FACTOR] * (n_layers - 1) + [DIM]
    ks = [(rng.standard_normal((dims[i], dims[i + 1])) * 0.4).astype(np.float32)
          for i in range(n_layers)]
    bs = [(rng.standard_normal(dims[i + 1]) * 0.1).astype(np.float32)
          for i in range(n_layers)]
    c_in, c_out = dims[0], dims[-1]
    ln = ((1.0 + 0.1 * rng.standard_normal(c_out)).astype(np.float32),
          (0.1 * rng.standard_normal(c_out)).astype(np.float32)) if has_ln else None
    # 3 x 37 = 111 rows: a multiple of no row tile of either kernel
    x = rng.standard_normal((3, 37, c_in)).astype(np.float32)
    res = rng.standard_normal((3, 37, c_out)).astype(np.float32) if has_res else None
    g = rng.standard_normal((3, 37, c_out)).astype(np.float32)
    return x, ks, bs, ln, res, g


def _ff_grads_jax(x, ks, bs, ln, res, g, approx, save, dtype):
    """(out, dx, dks, dbs, dln, dres) from jax.vjp of the JAX kernel."""
    j = jnp.asarray
    args = (j(x).astype(dtype), [j(k) for k in ks], [j(b) for b in bs],
            None if ln is None else tuple(j(a) for a in ln),
            None if res is None else j(res).astype(dtype))

    def f(x_, ks_, bs_, ln_, res_):
        return jax_fused_ff(x_, ks_, bs_, ln_, res_, approx_gelu=approx,
                            compute_dtype=dtype, interpret=True,
                            save_acts=save)

    out, vjp = jax.vjp(f, *args)
    dx, dks, dbs, dln, dres = vjp(j(g).astype(dtype))
    f32 = lambda a: None if a is None else np.asarray(  # noqa: E731
        jnp.asarray(a, jnp.float32))
    return (f32(out), f32(dx), [f32(a) for a in dks], [f32(a) for a in dbs],
            None if dln is None else [f32(a) for a in dln], f32(dres))


def _ff_grads_torch(x, ks, bs, ln, res, g, approx, save, dtype):
    """The same through the port's FusedFeedForward (its plain backward)."""
    t = lambda a: torch.from_numpy(a).requires_grad_()  # noqa: E731
    tx = torch.from_numpy(x).to(dtype).requires_grad_()
    tks, tbs = [t(k) for k in ks], [t(b) for b in bs]
    tln = None if ln is None else tuple(t(a) for a in ln)
    tres = (None if res is None
            else torch.from_numpy(res).to(dtype).requires_grad_())
    out = fused_ff.fused_feedforward(tx, tks, tbs, tln, tres,
                                     approx_gelu=approx, compute_dtype=dtype,
                                     save_acts=save)
    assert type(out.grad_fn)._forward_cls is fused_ff.FusedFeedForward
    out.backward(torch.from_numpy(g).to(dtype))
    f32 = lambda a: a.detach().float().numpy()  # noqa: E731
    return (f32(out), f32(tx.grad), [f32(k.grad) for k in tks],
            [f32(b.grad) for b in tbs],
            None if ln is None else [f32(a.grad) for a in tln],
            None if res is None else f32(tres.grad))


def _flat(grads):
    out, dx, dks, dbs, dln, dres = grads
    names = ["out", "dx"] + [f"dk{i}" for i in range(len(dks))] + \
        [f"db{i}" for i in range(len(dbs))]
    arrays = [out, dx, *dks, *dbs]
    if dln is not None:
        names += ["dln_scale", "dln_bias"]
        arrays += list(dln)
    if dres is not None:
        names.append("dres")
        arrays.append(dres)
    return dict(zip(names, arrays))


_VJP_CASES = [  # (n_layers, has_ln, approx, has_res, save)
    (3, True, True, True, False),    # the bench chain, recompute
    (3, True, True, True, True),     # the bench chain, fused_saved
    (3, False, False, False, False),
    (3, False, True, False, True),   # saved without LN: all but the last z
    (1, True, False, True, False),
    (1, False, True, False, True),   # one layer, no LN: nothing saved
    (2, True, False, False, True),
    (2, False, False, True, False),
]


@pytest.mark.parametrize("n_layers,has_ln,approx,has_res,save,dims", [
    *(pytest.param(*c, None, id="-".join(map(str, c))) for c in _VJP_CASES),
    # widths no multiple of 4: those of the f32 kernel's padded case in
    # chip_smoke.py, which holds the kernel to this plain backward
    pytest.param(3, True, True, False, False, [30, 50, 50, 30],
                 id="3-True-True-False-False-30x50x50x30"),
])
def test_fused_ff_backward_matches_jax_vjp(n_layers, has_ln, approx, has_res,
                                           save, dims):
    inputs = _ff_inputs(n_layers, has_ln, has_res, seed=n_layers * 10 + save,
                        dims=dims)
    want = _flat(_ff_grads_jax(*inputs, approx, save, jnp.float32))
    got = _flat(_ff_grads_torch(*inputs, approx, save, torch.float32))
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], **F32,
                                   err_msg=name)


@pytest.mark.parametrize("save", [False, True])
def test_fused_ff_backward_bf16_matches_jax_vjp(save):
    """bf16 compute and bf16 activations, the bench configuration."""
    inputs = _ff_inputs(3, True, True, seed=5)
    want = _flat(_ff_grads_jax(*inputs, True, save, jnp.bfloat16))
    got = _flat(_ff_grads_torch(*inputs, True, save, torch.bfloat16))
    for name in want:
        assert _rel(got[name], want[name]) <= 1e-2, name


@pytest.mark.parametrize("has_ln", [False, True])
@pytest.mark.parametrize("save", [False, True])
@pytest.mark.parametrize("approx", [False, True])
def test_fused_ff_backward_bf16_ragged_widths_match_jax_vjp(has_ln, save,
                                                            approx):
    """bf16 at widths that are no multiple of the tensor-core fragments
    (24 -> 40 -> 40 -> 24, 111 rows): the function whose zero-filled
    fragments and masked stores the CUDA kernel must reproduce."""
    inputs = _ff_inputs(3, has_ln, False, seed=20 + 4 * has_ln + 2 * save
                        + approx, dims=[24, 40, 40, 24])
    want = _flat(_ff_grads_jax(*inputs, approx, save, jnp.bfloat16))
    got = _flat(_ff_grads_torch(*inputs, approx, save, torch.bfloat16))
    assert got.keys() == want.keys()
    for name in want:
        assert np.isfinite(got[name]).all(), name
        assert _rel(got[name], want[name]) <= 1e-2, name


def test_fused_ff_backward_reference_direct():
    """The plain backward called directly (as the CUDA kernel is checked
    against it) equals the Function's backward, and its dtypes are the
    parameters'."""
    x, ks, bs, ln, res, g = _ff_inputs(3, True, True, seed=9)
    t = torch.from_numpy
    dx, dks, dbs, dln = fused_ff.fused_feedforward_bwd_reference(
        t(x), t(g), [t(k) for k in ks], [t(b) for b in bs],
        tuple(t(a) for a in ln), compute_dtype=torch.float32)
    _, fdx, fdks, fdbs, fdln, fdres = _ff_grads_torch(
        x, ks, bs, ln, res, g, True, False, torch.float32)
    np.testing.assert_array_equal(dx.numpy(), fdx)
    for a, b in zip(dks + dbs + list(dln), fdks + fdbs + fdln):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(fdres, g)  # the residual's gradient is g


def test_kernel_entries_are_autograd_functions():
    """Built from parameters that require gradients, the outputs of both
    kernel entries carry the port's Function as grad_fn (the CUDA entries
    of the serving slice detached their inputs, so on the card their
    outputs had none and only out_proj got a gradient)."""
    x, ks, bs, ln, res, _ = _ff_inputs(2, True, True, seed=1)
    t = lambda a: torch.from_numpy(a).requires_grad_()  # noqa: E731
    out = fused_ff.fused_feedforward(torch.from_numpy(x), [t(k) for k in ks],
                                     [t(b) for b in bs],
                                     tuple(t(a) for a in ln))
    assert type(out.grad_fn)._forward_cls is fused_ff.FusedFeedForward
    rng = np.random.default_rng(2)
    w = [t(_weight(rng, 4, 4, 5)) for _ in range(2)]
    out = tmix.factorized_spectral_conv_2d_pallas2(
        torch.from_numpy(rng.standard_normal((1, 8, 8, 4)).astype(np.float32)),
        *w, 5, compute_dtype=torch.float32)
    assert type(out.grad_fn)._forward_cls is tmix.SpectralConv2d


# -- spectral passes ---------------------------------------------------

def _weight(rng, c, o, modes):
    return (rng.standard_normal((c, o, modes, 2)) * 0.3).astype(np.float32)


# (n, n_modes, C, O); the last is a ragged shape of the bf16 kernel: n = 40,
# m = 17, 24 -> 40 channels
ADJOINT_CASES = [(16, 5, 4, 3), (16, 12, 4, 3), (15, 10, 4, 3),
                 (40, 17, 24, 40)]


@pytest.mark.parametrize(
    "n,n_modes,c,o", ADJOINT_CASES,
    ids=[f"{n}-{k}" if (c, o) == (4, 3) else f"{n}-{k}-{c}-{o}"
         for n, k, c, o in ADJOINT_CASES])
def test_axis_adjoint_and_weight_grad_match_jax_vjp(n, n_modes, c, o):
    """One axis pass: the plain adjoint and the weight blocks' gradient
    (carried to the (C, O, modes, 2) weight by mix_blocks' autograd)
    against jax.vjp of both JAX kernels (packed K2 in f32, unpacked K3)."""
    rng = np.random.default_rng(n * 7 + n_modes)
    rows = 5
    x = rng.standard_normal((rows, n, c)).astype(np.float32)
    w = _weight(rng, c, o, n_modes)
    g = rng.standard_normal((rows, n, o)).astype(np.float32)
    m = min(n_modes, n // 2 + 1)
    cpu = torch.device("cpu")
    tw = torch.from_numpy(w).requires_grad_()
    wpk = tmix.pack_mix_weight(tw, m)
    dx = tmix.spectral_adjoint_reference(
        torch.from_numpy(g), *tmix.adjoint_factors(n, m, "ortho", cpu),
        wpk.detach(), torch.float32)
    dwab = tmix.spectral_weight_grad(
        torch.from_numpy(x)[None], torch.from_numpy(g)[None], m, 2, "ortho",
        torch.float32)
    tmix.mix_blocks(tw, m).backward(dwab)
    for op in (lambda a, b: jmix2.packed_spectral_mix_1d(
                   a, b, n_modes, interpret=True, compute_dtype=jnp.float32),
               lambda a, b: jmix.truncated_spectral_mix_1d(
                   a, b, n_modes, interpret=True)):
        _, vjp = jax.vjp(op, jnp.asarray(x), jnp.asarray(w))
        jdx, jdw = vjp(jnp.asarray(g))
        np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **F32)
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), **F32)


# (n, n_modes, C, O): ragged shapes of the f32 kernel's tiles, and wider
# channels than a tile of 4 rows holds
F32_ADJOINT_CASES = [(40, 17, 24, 40), (15, 10, 4, 3), (32, 17, 5, 3),
                     (16, 8, 136, 96)]


@pytest.mark.parametrize(
    "n,n_modes,c,o", F32_ADJOINT_CASES,
    ids=[f"{n}-{k}-{c}-{o}" for n, k, c, o in F32_ADJOINT_CASES])
def test_f32_kernel_adjoint_operands_match_jax_vjp(n, n_modes, c, o):
    """The adjoint computed plainly from the f32 kernel's own operands (the
    adjoint's padded factors and the padded blocks a^T | -b^T) against
    jax.vjp of the JAX package's f32-exact kernel in interpret mode."""
    rng = np.random.default_rng(n * 13 + o)
    x = rng.standard_normal((5, n, c)).astype(np.float32)
    w = _weight(rng, c, o, n_modes)
    g = rng.standard_normal((5, n, o)).astype(np.float32)
    m = min(n_modes, n // 2 + 1)
    f2p, i2p = tmix.kernel_factors_f32(n, m, "ortho", torch.device("cpu"),
                                       adjoint=True)
    wk = tmix.kernel_weight_f32(
        tmix.adjoint_blocks(tmix.mix_blocks(torch.from_numpy(w), m)))
    dx = _plain_pass_f32_operands(torch.from_numpy(g), f2p, i2p, wk, n, m,
                                  o, c)
    _, vjp = jax.vjp(lambda a, b: jmix.truncated_spectral_mix_1d(
        a, b, n_modes, interpret=True), jnp.asarray(x), jnp.asarray(w))
    jdx, _ = vjp(jnp.asarray(g))
    assert dx.shape == (5, n, c)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **F32)


def test_axis_adjoint_is_the_adjoint():
    """<pass(x), g> = <x, adjoint(g)> along both axes of a channels-last
    tensor, with a different m per axis. The plain versions multiply in
    f32, so the two sides agree to f32 roundoff."""
    rng = np.random.default_rng(3)
    b, h, w, c, o = 2, 12, 16, 4, 3
    x = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((b, h, w, o)).astype(np.float32))
    for axis, m in ((2, 6), (1, 7)):
        wab = tmix.mix_blocks(torch.from_numpy(_weight(rng, c, o, m)), m)
        y = tmix.spectral_axis_pass(x, wab, axis, "ortho", torch.float32)
        dx = tmix.spectral_axis_adjoint(g, wab, axis, "ortho", torch.float32)
        lhs = float((y.double() * g.double()).sum())
        rhs = float((x.double() * dx.double()).sum())
        assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


def _conv_inputs(seed, b=2, h=12, w=16, c=4, modes=6):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, w, c)).astype(np.float32),
            _weight(rng, c, c, modes), _weight(rng, c, c, modes),
            rng.standard_normal((b, h, w, c)).astype(np.float32))


def _conv_grads_torch(fn, x, wy, wx, g, dtype=torch.float32):
    tx = torch.from_numpy(x).to(dtype).requires_grad_()
    twy = torch.from_numpy(wy).requires_grad_()
    twx = torch.from_numpy(wx).requires_grad_()
    out = fn(tx, twy, twx)
    out.backward(torch.from_numpy(g).to(dtype))
    return out, [a.grad.float().numpy() for a in (tx, twy, twx)]


@pytest.mark.parametrize("h,w,modes", [(12, 16, 6), (10, 7, 9)])
def test_conv_gradients_match_jax_vjp(h, w, modes):
    """Both axes (the H pass's adjoint added into the W pass's), f32,
    against the pallas2 and pallas convs of the JAX package."""
    x, wy, wx, g = _conv_inputs(h * w, h=h, w=w, modes=modes)
    out, got = _conv_grads_torch(
        lambda a, b, c: tmix.factorized_spectral_conv_2d_pallas2(
            a, b, c, modes, compute_dtype=torch.float32), x, wy, wx, g)
    assert type(out.grad_fn)._forward_cls is tmix.SpectralConv2d
    from resolution_pde_tpu.ops import spectral as jspec
    jops = [lambda a, b, c: jmix2.factorized_spectral_conv_2d_pallas2(
                a, b, c, modes, compute_dtype=jnp.float32, interpret=True),
            lambda a, b, c: jspec.factorized_spectral_conv_2d_pallas(
                a, b, c, modes, interpret=True)]
    for op in jops:
        _, vjp = jax.vjp(op, *(jnp.asarray(a) for a in (x, wy, wx)))
        for a, b in zip(got, vjp(jnp.asarray(g))):
            assert _rel(a, b) <= 1e-4


def test_conv_gradients_bf16_match_jax_vjp():
    x, wy, wx, g = _conv_inputs(11, h=16, w=24, modes=9)
    _, got = _conv_grads_torch(
        lambda a, b, c: tmix.factorized_spectral_conv_2d_pallas2(
            a, b, c, 9, compute_dtype=torch.bfloat16), x, wy, wx, g,
        dtype=torch.bfloat16)
    _, vjp = jax.vjp(
        lambda a, b, c: jmix2.factorized_spectral_conv_2d_pallas2(
            a, b, c, 9, compute_dtype=jnp.bfloat16, interpret=True),
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(wy), jnp.asarray(wx))
    want = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    for a, b in zip(got, want):
        assert _rel(a, jnp.asarray(b, jnp.float32)) <= 1e-2


def test_conv_backward_takes_a_strided_cotangent():
    """A cotangent whose channel stride is not 1 is made contiguous."""
    x, wy, wx, g = _conv_inputs(4)
    fn = lambda a, b, c: tmix.factorized_spectral_conv_2d_pallas2(  # noqa: E731
        a, b, c, 6, compute_dtype=torch.float32)
    _, want = _conv_grads_torch(fn, x, wy, wx, g)
    tx = torch.from_numpy(x).requires_grad_()
    twy = torch.from_numpy(wy).requires_grad_()
    twx = torch.from_numpy(wx).requires_grad_()
    gt = torch.from_numpy(np.ascontiguousarray(g.transpose(0, 3, 1, 2)))
    out = fn(tx, twy, twx)
    out.backward(gt.permute(0, 2, 3, 1))  # channel stride H * W
    for a, b in zip((tx, twy, twx), want):
        np.testing.assert_array_equal(a.grad.numpy(), b)


# -- FFNO2D ------------------------------------------------------------

CFG = dict(in_channels=1, out_channels=1, width=6, n_layers=2, n_modes=8,
           factor=2, ff_weight_norm=True, n_ff_layers=3, layer_norm=True,
           dropout=0.0)
GRID = (12, 16)


@pytest.fixture(scope="module")
def jax_params():
    x = jnp.zeros((1, 1) + GRID, jnp.float32)
    return JaxFFNO2D(**CFG).init(jax.random.key(0), x)


_JAX_GRADS = {}


def _data(seed=0, batch=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, 1) + GRID).astype(np.float32)
    return x, np.roll(x, 3, axis=-1)


def _jax_grads(params, x, y, **kw):
    """jax.grad of the loss on (x, y), cached per model configuration (the
    tests of one configuration share their data)."""
    key = tuple(sorted((k, str(v)) for k, v in kw.items()))
    if key not in _JAX_GRADS:
        model = JaxFFNO2D(**CFG, **kw)

        def loss(p):
            return jax_rel_l2(model.apply({"params": p}, jnp.asarray(x)),
                              jnp.asarray(y))

        _JAX_GRADS[key] = jax.grad(loss)(params["params"])
    return _JAX_GRADS[key]


def _port_grads(params, x, y, **kw):
    model = FFNO2D(**CFG, **kw)
    model.load_state_dict(ffno2d_state_dict(params))
    relative_l2(model(torch.from_numpy(x)), torch.from_numpy(y)).backward()
    return {k: p.grad for k, p in model.named_parameters()}


def test_bridge_maps_a_gradient_tree(jax_params):
    """jax.grad gives a tree of the params' structure, so the bridge maps
    it to the port's parameter names and shapes."""
    x, y = _data()
    grads = ffno2d_state_dict(_jax_grads(jax_params, x, y,
                                         spectral_impl="pallas2",
                                         ff_impl="fused"))
    model = FFNO2D(**CFG)
    assert {k: tuple(v.shape) for k, v in grads.items()} == {
        k: tuple(v.shape) for k, v in model.named_parameters()}


@pytest.mark.parametrize("spectral_impl,ff_impl", [
    ("pallas2", "fused"), ("pallas", "fused_saved")])
def test_ffno2d_gradients_match_jax(jax_params, spectral_impl, ff_impl):
    x, y = _data()
    kw = dict(spectral_impl=spectral_impl, ff_impl=ff_impl)
    want = ffno2d_state_dict(_jax_grads(jax_params, x, y, **kw))
    got = _port_grads(jax_params, x, y, **kw)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.isfinite(got[k]).all() and got[k].abs().sum() > 0, k
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **F32,
                                   err_msg=k)
    flat = lambda d: np.concatenate([d[k].numpy().ravel() for k in want])  # noqa: E731
    assert _rel(flat(got), flat(want)) <= 1e-4


def test_ffno2d_bf16_gradients_match_jax(jax_params):
    x, y = _data(seed=1)
    kw = dict(spectral_impl="pallas2", ff_impl="fused", approx_gelu=True)
    want = ffno2d_state_dict(_jax_grads(jax_params, x, y,
                                        compute_dtype=jnp.bfloat16, **kw))
    got = _port_grads(jax_params, x, y, compute_dtype=torch.bfloat16, **kw)
    flat = lambda d: np.concatenate([d[k].float().numpy().ravel()  # noqa: E731
                                     for k in sorted(want)])
    assert _rel(flat(got), flat(want)) <= 1e-2


@pytest.mark.parametrize("transpose", [False, True])
def test_packed_weights_pad_to_whole_fragments(transpose):
    """The bf16 backward kernel reads its weights in whole 16 x 16
    fragments: each layer's kernel, packed as (in, out) or transposed, is
    zero-padded to multiples of 16 in both dimensions; unpadded (pad 1) the
    packing is the plain row-major one that the f32 forward reads."""
    rng = np.random.default_rng(4)
    ks = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for s in ((24, 40), (40, 24))]
    w = fused_ff._packed_weights(ks, torch.bfloat16, transpose, pad=16)
    assert w.dtype == torch.bfloat16 and w.numel() == 2 * 48 * 32
    off = 0
    for k in ks:
        k = k.t() if transpose else k
        rows, cols = (-(-d // 16) * 16 for d in k.shape)
        block = w[off:off + rows * cols].view(rows, cols)
        assert torch.equal(block[:k.shape[0], :k.shape[1]], k.to(torch.bfloat16))
        assert not block[k.shape[0]:].any() and not block[:, k.shape[1]:].any()
        off += rows * cols
    plain = fused_ff._packed_weights(ks, torch.float32, transpose)
    assert torch.equal(plain, torch.cat([(k.t() if transpose else k)
                                         .reshape(-1) for k in ks]))


@pytest.mark.parametrize("cd,pad", [(torch.bfloat16, 16), (torch.float32, 4)])
def test_backward_kernel_packing(cd, pad):
    """The backward kernel reads each layer's kernel row-major (``w``) and
    transposed (``wt``), zero-padded to multiples of 16 in bf16 (whole
    tensor-core fragments) and of 4 in f32 (the 16-byte pieces its f32
    products stream into shared memory), at widths no multiple of 4."""
    rng = np.random.default_rng(6)
    ks = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for s in ((30, 50), (50, 50), (50, 30))]
    w, wt = fused_ff._backward_weights(ks, cd)
    for packed, transpose in ((w, False), (wt, True)):
        assert packed.dtype == cd
        off = 0
        for k in ks:
            k = k.t() if transpose else k
            rows, cols = (-(-d // pad) * pad for d in k.shape)
            block = packed[off:off + rows * cols].view(rows, cols)
            assert torch.equal(block[:k.shape[0], :k.shape[1]], k.to(cd))
            assert not block[k.shape[0]:].any()
            assert not block[:, k.shape[1]:].any()
            off += rows * cols
        assert off == packed.numel()
    assert torch.equal(w, fused_ff._packed_weights(ks, cd, pad=pad))


@pytest.mark.parametrize("cd", [torch.bfloat16, torch.float32])
def test_forward_kernel_packing(cd):
    """The forward kernel streams each layer's (in, out) kernel row-major:
    in bf16 zero-padded to whole 16 x 16 fragments (the backward's ``w``,
    not its transposed ``wt``), in f32 zero-padded to multiples of 4 (the
    16-byte pieces its f32 products stream into shared memory; the
    backward's f32 ``w``), also at widths no multiple of 4."""
    rng = np.random.default_rng(5)
    ks = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for s in ((24, 40), (40, 24))]
    w = fused_ff._forward_weights(ks, cd)
    assert w.dtype == cd
    if cd == torch.bfloat16:
        assert torch.equal(w, fused_ff._packed_weights(ks, cd, pad=16))
        assert w.numel() == 32 * 48 + 48 * 32
        assert not torch.equal(w, fused_ff._packed_weights(ks, cd, True, 16))
    else:
        assert torch.equal(w, torch.cat([k.reshape(-1) for k in ks]))
        ks = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for s in ((30, 50), (50, 30))]
        w = fused_ff._forward_weights(ks, cd)
        assert torch.equal(w, fused_ff._backward_weights(ks, cd)[0])
        assert w.numel() == 32 * 52 + 52 * 32
        off = 0
        for k in ks:
            rows, cols = (-(-d // 4) * 4 for d in k.shape)
            block = w[off:off + rows * cols].view(rows, cols)
            assert torch.equal(block[:k.shape[0], :k.shape[1]], k)
            assert not block[k.shape[0]:].any()
            assert not block[:, k.shape[1]:].any()
            off += rows * cols
