"""The port's S4ND path on the CPU against the JAX package: the recurrent
discretizations (``ops.ssm.discretize_*``), both recurrent step functions
across the kernel option surface, ``ops.spectral.irfftn`` against numpy on
spectra whose DC and Nyquist bins are not real, S4NDLayer in 1D, 2D and 3D
(both modes, bidirectional, linear), S4NDModel (both modes, pre- and
post-norm) on the JAX variables carried over by ``utils.jax_bridge``, the
'pallas' route's plain versions against 'jnp', S4NDModel served through
the port's ServingEngine, and ``main_2d model=s4_2d`` through both
command lines from the same initial weights.

Tolerances: relative L2 1e-5 for a layer where both sides run the same f32
formulation, 1e-4 at the model level, across routes and for the
discretizations (a dense complex inverse and matrix power in f32 on both
sides, by different LAPACK paths); a recurrence against the convolution
at JAX's own rtol 1e-3 / atol 1e-4 (tests/test_s4.py); the command lines'
losses, sweep and rollout 1e-4 relative.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
h5py = pytest.importorskip("h5py")
import jax.numpy as jnp  # noqa: E402

from resolution_pde_tpu.cli.main_2d import main as jax_main  # noqa: E402
from resolution_pde_tpu.models import s4 as js4  # noqa: E402
from resolution_pde_tpu.ops import ssm as jssm  # noqa: E402
from resolution_pde_tpu_torch.cli import common  # noqa: E402
from resolution_pde_tpu_torch.cli.main_2d import main  # noqa: E402
from resolution_pde_tpu_torch.configs import parse_cli  # noqa: E402
from resolution_pde_tpu_torch.deploy import ServingEngine  # noqa: E402
from resolution_pde_tpu_torch.models import get_model, s4  # noqa: E402
from resolution_pde_tpu_torch.ops import ssm  # noqa: E402
from resolution_pde_tpu_torch.ops.spectral import irfftn  # noqa: E402
from resolution_pde_tpu_torch.train import save_checkpoint  # noqa: E402
from resolution_pde_tpu_torch.utils.jax_bridge import (  # noqa: E402
    s4nd_layer_state_dict, s4nd_model_state_dict)

SAME = 1e-5   # a layer, same f32 formulation on both sides
MODEL = 1e-4  # the model level, across routes, the discretizations
CONV_RTOL, CONV_ATOL = 1e-3, 1e-4  # recurrence vs conv, tests/test_s4.py
JAX_DEVICES = 8  # tests/conftest.py


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.complex128)
    want = np.asarray(want, np.complex128)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _c(rng, shape, scale=1.0):
    return (scale * (rng.standard_normal(shape)
                     + 1j * rng.standard_normal(shape))).astype(np.complex64)


def _t(a):
    return torch.from_numpy(np.array(a))


def _sd(tree) -> dict:
    return {k: _t(v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# discretize_*
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn,per_state", [
    ("discretize_diag_zoh", False), ("discretize_diag_zoh", True),
    ("discretize_diag_bilinear", False), ("discretize_diag_bilinear", True)])
def test_discretize_diag_matches_jax(fn, per_state):
    rng = np.random.default_rng(0)
    h, n = 4, 8
    A = (-np.abs(rng.standard_normal((h, n)))
         + 1j * 3 * rng.standard_normal((h, n))).astype(np.complex64)
    dt = np.exp(rng.uniform(-6, -2, (h, n) if per_state else (h, 1))
                ).astype(np.float32)
    want = getattr(jssm, fn)(jnp.asarray(A), None, dt=jnp.asarray(dt))
    got = getattr(ssm, fn)(_t(A), None, dt=_t(dt))
    for g, w in zip(got, want):
        assert g.dtype == torch.complex64
        assert rel_l2(g.numpy(), w) <= SAME
    # log_dt gives the same as its exp
    via_log = getattr(ssm, fn)(_t(A), torch.log(_t(dt)))
    for g, w in zip(via_log, got):
        assert rel_l2(g.numpy(), w.numpy()) <= SAME


@pytest.mark.parametrize("rank,per_state,L", [(1, False, 16), (2, False, 12),
                                              (1, True, 64)])
def test_discretize_dplr_matches_jax(rank, per_state, L):
    """Per feature (JAX vmaps the per-feature function; the port batches
    over leading dimensions), on HiPPO-LegS spectra."""
    rng = np.random.default_rng(1)
    h, n = 3, 8
    lam, p, b, _ = jssm.make_dplr_hippo(n)
    Lam = np.broadcast_to(lam, (h, n)).astype(np.complex64)
    P = (np.broadcast_to(p, (rank, h, n))
         + 0.1 * _c(rng, (rank, h, n))).astype(np.complex64)
    B = np.broadcast_to(b, (h, n)).astype(np.complex64)
    Ct = _c(rng, (h, n), 0.5)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1),
                            (h, n) if per_state else (h,))
                ).astype(np.float32)
    p_j = P[0] if rank == 1 else np.moveaxis(P, 0, 1)   # (H, N) | (H, R, N)
    want = jax.vmap(lambda lm, pp, bb, cc, d: jssm.discretize_dplr(
        lm, pp, bb, cc, None, L, dt=d))(*map(jnp.asarray,
                                             (Lam, p_j, B, Ct, dt)))
    dt_t = _t(dt if per_state else dt[:, None])
    got = ssm.discretize_dplr(_t(Lam), _t(p_j), _t(B), _t(Ct), None, L,
                              dt=dt_t)
    for g, w in zip(got, want):
        assert g.dtype == torch.complex64
        assert rel_l2(g.numpy(), w) <= MODEL


# ---------------------------------------------------------------------------
# The recurrent step functions
# ---------------------------------------------------------------------------

def _run_steps(init_state, step, u, to_in, to_np):
    state = init_state(u.shape[0])
    ys = []
    for t in range(u.shape[-1]):
        state, y = step(state, to_in(u[:, :, t]))
        ys.append(to_np(y))
    return np.stack(ys, axis=-1)


def _step_case(cls_name, opts, step_keys, L, key):
    """A JAX kernel layer's parameters, the port's layer holding them, and
    the step options of ``opts``."""
    jl = getattr(js4, cls_name)(d_model=4 if cls_name[0] == "S" else 2,
                                d_state=8, channels=1, **opts)
    params = jl.init(jax.random.key(key), L)["params"]
    if opts.get("rank", 1) > 1:  # the zero-padded rank row participates
        params = dict(params)
        params["P_vec"] = params["P_vec"] + 0.2 * jax.random.normal(
            jax.random.key(key), params["P_vec"].shape)
    layer = getattr(s4, cls_name)(d_model=jl.d_model, d_state=8, channels=1,
                                  **opts)
    layer.load_state_dict(_sd(params))
    step_kw = {k: opts[k] for k in step_keys if k in opts}
    return jl, params, layer, step_kw


S4D_STEP_KEYS = ("dt_transform", "dt_fast", "real_transform",
                 "imag_transform", "is_real", "bandlimit")
DPLR_STEP_KEYS = ("dt_transform", "dt_fast", "real_transform", "bandlimit")


@pytest.mark.parametrize("opts", [
    dict(), dict(dt_tie=False), dict(dt_transform="softplus"),
    dict(dt_fast=True), dict(is_real=True), dict(imag_transform="exp"),
    dict(real_transform="softplus"),
    dict(disc="bilinear", dt_transform="sigmoid", dt_fast=True),
    dict(n_ssm=2, dt_tie=False), dict(bandlimit=0.05),
], ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()) or "default")
def test_s4d_recurrent_step_fn(opts):
    """The port's steps against JAX's on the same parameters, and against
    the port's own convolution at JAX's tolerance."""
    L = 16
    jl, params, layer, kw = _step_case("S4DKernelLayer", opts,
                                       S4D_STEP_KEYS, L, 1)
    disc = opts.get("disc", "zoh")
    u = np.random.default_rng(2).standard_normal((2, 4, L)).astype(
        np.float32)
    want = _run_steps(*js4.s4d_recurrent_step_fn(params, disc=disc, **kw),
                      u, jnp.asarray, np.asarray)
    # the module, and its state_dict, give the same steps
    got = _run_steps(*s4.s4d_recurrent_step_fn(layer, disc=disc, **kw), u,
                     torch.from_numpy, lambda y: y.numpy())
    again = _run_steps(*s4.s4d_recurrent_step_fn(layer.state_dict(),
                                                 disc=disc, **kw), u,
                       torch.from_numpy, lambda y: y.numpy())
    np.testing.assert_array_equal(got, again)
    assert rel_l2(got, want) <= MODEL
    with torch.no_grad():
        conv = ssm.fft_causal_conv(torch.from_numpy(u), layer(L)[0][None])
    np.testing.assert_allclose(got, conv.numpy(), rtol=CONV_RTOL,
                               atol=CONV_ATOL)


@pytest.mark.parametrize("opts", [
    dict(), dict(dt_tie=False), dict(dt_transform="softplus", dt_fast=True),
    dict(real_transform="softplus"), dict(bandlimit=0.05), dict(rank=2),
], ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()) or "default")
def test_dplr_recurrent_step_fn(opts):
    L = 12
    jl, params, layer, kw = _step_case("DPLRKernelLayer", opts,
                                       DPLR_STEP_KEYS, L, 2)
    u = np.random.default_rng(3).standard_normal((2, 2, L)).astype(
        np.float32)
    want = _run_steps(*js4.dplr_recurrent_step_fn(params, L, **kw), u,
                      jnp.asarray, np.asarray)
    got = _run_steps(*s4.dplr_recurrent_step_fn(layer, L, **kw), u,
                     torch.from_numpy, lambda y: y.numpy())
    assert rel_l2(got, want) <= MODEL
    with torch.no_grad():
        conv = ssm.fft_causal_conv(torch.from_numpy(u), layer(L)[0][None])
    np.testing.assert_allclose(got, conv.numpy(), rtol=CONV_RTOL,
                               atol=CONV_ATOL)


def test_recurrent_step_refusals():
    with pytest.raises(ValueError, match="no recurrent form"):
        s4.s4d_recurrent_step_fn(s4.S4DKernelLayer(4, 8, disc="dss"),
                                 disc="dss")


# ---------------------------------------------------------------------------
# irfftn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [(6, 8), (5, 7), (4, 6, 8), (3, 5, 9)])
def test_irfftn_reads_the_last_axis_edges_as_real(s):
    """Non-Hermitian spectra (every bin complex, DC and Nyquist of the last
    axis included) as numpy.fft.irfftn reads them."""
    rng = np.random.default_rng(4)
    z = _c(rng, (2,) + s[:-1] + (s[-1] // 2 + 1,))
    got = irfftn(torch.from_numpy(z), s).numpy()
    want = np.fft.irfftn(z, s, axes=tuple(range(-len(s), 0)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # axes given explicitly, not the last ones
    zt = np.moveaxis(z, 0, -1).copy()
    dims = tuple(range(len(s)))
    got = irfftn(torch.from_numpy(zt), s, dim=dims).numpy()
    np.testing.assert_allclose(got, np.fft.irfftn(zt, s, axes=dims),
                               rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="sizes for"):
        irfftn(torch.from_numpy(z), s, dim=(-1,))


# ---------------------------------------------------------------------------
# S4NDLayer, S4NDModel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,mode,bidirectional,linear", [
    ((12,), "diag", False, False),
    ((8, 12), "diag", True, False),
    ((8, 12), "dplr", False, False),
    ((8, 6), "dplr", True, True),
    ((4, 5, 6), "diag", False, True),
    ((4, 6, 5), "dplr", True, False),
])
def test_s4nd_layer_matches_jax(shape, mode, bidirectional, linear):
    c = 6
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2,) + shape + (c,)).astype(np.float32)
    cls = js4.S4ND2dLayer if len(shape) == 2 else js4.S4NDLayer
    jl = cls(d_model=c, d_state=8, bidirectional=bidirectional, mode=mode,
             linear=linear)
    params = jl.init(jax.random.key(6), jnp.asarray(x))["params"]
    want = np.asarray(jl.apply({"params": params}, jnp.asarray(x)))
    layer = (s4.S4ND2dLayer if len(shape) == 2 else s4.S4NDLayer)(
        c, d_state=8, bidirectional=bidirectional, mode=mode, linear=linear,
        ndim=len(shape))
    layer.load_state_dict(s4nd_layer_state_dict(params))
    names = [n for n, _ in layer.named_children() if n.startswith("kernel")]
    assert names == (["kernel_x", "kernel_y"] if len(shape) == 2
                     else [f"kernel_ax{i}" for i in range(len(shape))])
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == x.shape
    assert rel_l2(got, want) <= SAME
    with pytest.raises(ValueError, match="spatial axes"):
        layer(torch.from_numpy(x[:, 0]))


def _model_pair(mode, **kw):
    """A JAX S4NDModel's variables on a (2, 1, 12, 16) input, its output,
    and the port's model holding them."""
    cfg = dict(d_input=1, d_output=1, d_model=8, n_layers=2, dropout=0.0,
               mode=mode, **kw)
    x = np.random.default_rng(7).standard_normal((2, 1, 12, 16)).astype(
        np.float32)
    jm = js4.S4NDModel(**cfg)
    params = jm.init(jax.random.key(8), jnp.asarray(x))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    model = s4.S4NDModel(**cfg)
    model.load_state_dict(s4nd_model_state_dict(params))
    return model, x, want


@pytest.mark.parametrize("mode,kw", [
    ("diag", {}), ("dplr", {}),
    ("diag", dict(prenorm=True, bidirectional=True)),
    ("dplr", dict(s4nd_linear=True, bidirectional=True)),
])
def test_s4nd_model_matches_jax(mode, kw):
    model, x, want = _model_pair(mode, **kw)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 1, 12, 16)
    assert rel_l2(got, want) <= MODEL


@pytest.mark.parametrize("mode", ["diag", "dplr"])
def test_s4nd_pallas_route_plain_matches_jnp(mode):
    """kernel_impl='pallas' on the CPU runs the K4/K5 wrappers' plain
    versions, per axis at L 12 and 16: the same function as 'jnp'; served
    through the port's ServingEngine (a request of 3 in a bucket of 4)."""
    model, x, want = _model_pair(mode)
    pallas = s4.S4NDModel(d_input=1, d_output=1, d_model=8, n_layers=2,
                          dropout=0.0, mode=mode, kernel_impl="pallas")
    pallas.load_state_dict(model.state_dict())
    with torch.no_grad():
        got = pallas(torch.from_numpy(x)).numpy()
        ref = model(torch.from_numpy(x)).numpy()
    assert rel_l2(got, ref) <= MODEL
    assert rel_l2(got, want) <= MODEL
    eng = ServingEngine(pallas, device="cpu")
    eng.warmup(spatial_shapes=[(12, 16)], batch_sizes=[4])
    xs = np.concatenate([x, x[:1]])
    served = eng.predict(xs)
    assert rel_l2(served[:2], got) <= SAME
    # the kernels are forward-only
    y = s4.S4NDModel(d_input=1, d_model=8, n_layers=1, mode=mode,
                     kernel_impl="pallas")(torch.from_numpy(x))
    with pytest.raises(NotImplementedError, match="forward-only"):
        y.square().mean().backward()


def test_s4nd_model_input_width_and_registry():
    model = s4.S4NDModel(d_input=3, d_model=8, n_layers=1)
    assert model.encoder.in_features == 5
    with pytest.raises(ValueError, match="d_input=3.*1 input channels.*5"):
        model(torch.zeros(1, 1, 8, 8))
    for name in ("S4NDModel", "models.s4_2d.S4NDModel"):
        assert get_model(name) is s4.S4NDModel
    with pytest.raises(ValueError, match="kernel_impl"):
        s4.S4NDModel(kernel_impl="cuda")


# ---------------------------------------------------------------------------
# main_2d model=s4_2d
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _cwd(path):
    old = os.getcwd()
    os.makedirs(path, exist_ok=True)
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


@pytest.fixture(scope="module")
def ns_dir(tmp_path_factory):
    """10 trajectories x 5 frames at 32²: smooth fields shifted in time."""
    d = tmp_path_factory.mktemp("s4nd_cli")
    rng = np.random.default_rng(11)
    f = np.fft.rfft2(rng.standard_normal((10, 32, 32)))
    f[:, 5:-5, :] = 0
    f[:, :, 5:] = 0
    base = np.fft.irfft2(f, s=(32, 32)).astype(np.float32)
    u = np.stack([np.roll(base, i, axis=-1) for i in range(5)], axis=1)
    with h5py.File(d / "ns.h5", "w") as fh:
        fh.create_dataset("u", data=u)
    return d


def _argv(d, mode, *extra):
    return ["model=s4_2d", "dataset=ns_naive",
            f"dataset.dataset_params.saved_folder={d}",
            "dataset.dataset_params.filename=ns.h5",
            "dataset.original_res=32", "dataset.max_test_resolution=32",
            "dataset.rollout_steps=2", "model.d_input=1", "model.d_output=1",
            "model.dropout=0", "model.d_model=8", "model.n_layers=2",
            f"model.mode={mode}", *extra]


@pytest.mark.parametrize("mode", ["diag", "dplr"])
def test_main_2d_s4nd_matches_jax(ns_dir, tmp_path, monkeypatch, mode):
    """main_2d model=s4_2d for 2 epochs from JAX's command line's initial
    weights (its model's init under jax.random.key(training.seed)), the
    port at the ×8 batch of JAX's 8-device mesh: the loss history, test
    loss, sweep and a two-step rollout within 1e-4. The state-space
    parameters train at the ssm_lr rate with no weight decay, as in JAX
    (``Trainer``'s groups by leaf name, checked here too)."""
    from resolution_pde_tpu.configs import (instantiate_model as jax_model,
                                            parse_cli as jax_parse_cli)

    monkeypatch.delenv("SLURM_JOB_ID", raising=False)
    argv = _argv(ns_dir, mode)
    variables = jax.jit(jax_model(jax_parse_cli(argv).model).init)(
        jax.random.key(0), jnp.zeros((2, 1, 32, 32)))
    cfg = parse_cli(argv)
    model = common.build_model(cfg)
    assert isinstance(model, s4.S4NDModel)
    model.load_state_dict(s4nd_model_state_dict(variables["params"]))
    state = common.build_trainer(cfg, model, None, device="cpu").init()
    init = str(tmp_path / "port_init")
    save_checkpoint(init, state)
    groups = {id(p): g for g in state.optimizer.param_groups
              for p in g["params"]}
    lr = cfg.training.get("learning_rate", 1e-3)
    for name, p in model.named_parameters():
        g = groups[id(p)]
        ssm_leaf = name.rsplit(".", 1)[-1] in s4.SSM_PARAM_NAMES
        assert (g["weight_decay"] == 0.0) == ssm_leaf, name
        assert g["lr"] == pytest.approx(min(1e-3, lr) if ssm_leaf else lr)
        if ssm_leaf:
            assert ".kernel_" in name
    run = ["training.epochs=2"]
    with _cwd(tmp_path / "jax"):
        want = jax_main(argv + run + ["training.batch_size=2"])
    with _cwd(tmp_path / "port"):
        got = main(argv + run + [f"training.batch_size={2 * JAX_DEVICES}",
                                 f"dataset.saved_checkpoint_path={init}"],
                   device="cpu")
    for k in ("train_loss", "val_loss", "lr"):
        np.testing.assert_allclose(getattr(got["history"], k),
                                   getattr(want["history"], k), rtol=MODEL)
    assert got["test_loss"] == pytest.approx(want["test_loss"], rel=MODEL)
    for key in ("super_resolution", "rollout"):
        assert sorted(got[key]) == sorted(want[key]) == [32]
        assert got[key][32] == pytest.approx(want[key][32], rel=MODEL), key
    assert got["n_params"] == want["n_params"]
