"""The port's CNO against the JAX package's on the CPU: the antialiased
bicubic resize and CNO's activation (1D and 2D, up and down), the
designed filters (taps byte for byte, both ``radial`` settings) and the
filtered resampling and activation; CNO1d, CNO2d and CNO2dOriginal (2
levels, 1 residual block a level and in the neck, multiplier 4, size 32)
on the same variables carried over by utils.jax_bridge: the forward in
eval and in train mode, every parameter's gradient of a weighted sum of
the train-mode output, and the BatchNorm running statistics after the
train-mode forward against flax's updated ``batch_stats``; the bridge's
round trip with resolution_pde_tpu.utils.torch_import.import_cno1d/2d; the
initialiser; the size check; and the rollout in eval mode whatever the
caller's mode.

Tolerances: the ops 1e-5 (max abs over max abs), the models' outputs and
gradients relative L2 1e-4, the running statistics 1e-5; the references
of the train-mode output, gradients and statistics are JAX's computed in
float64 (``check_against_jax`` says why). A conv bias in
front of a BatchNorm has no gradient in exact arithmetic (the norm takes
the batch mean out), so both sides' are roundoff: those are held to 1e-4
of the whole gradient's norm.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from resolution_pde_tpu.models.cno import CNO1d as JaxCNO1d  # noqa: E402
from resolution_pde_tpu.models.cno import CNO2d as JaxCNO2d  # noqa: E402
from resolution_pde_tpu.models.cno_original import (  # noqa: E402
    CNO2dOriginal as JaxCNO2dOriginal)
from resolution_pde_tpu.ops import filters as jfilters  # noqa: E402
from resolution_pde_tpu.ops import interpolation as jinterp  # noqa: E402
from resolution_pde_tpu.utils.torch_import import (import_cno1d,  # noqa: E402
                                                   import_cno2d)
from resolution_pde_tpu_torch.evaluation import rollout_loss  # noqa: E402
from resolution_pde_tpu_torch.models import get_model  # noqa: E402
from resolution_pde_tpu_torch.models.cno import CNO1d, CNO2d  # noqa: E402
from resolution_pde_tpu_torch.models.cno_original import (  # noqa: E402
    CNO2dOriginal)
from resolution_pde_tpu_torch.models.norms import BatchNorm  # noqa: E402
from resolution_pde_tpu_torch.ops import filters, interpolation  # noqa: E402
from resolution_pde_tpu_torch.utils import jax_bridge  # noqa: E402

RTOL = 1e-4
OPS_TOL = 1e-5
STATS_TOL = 1e-5
SMALL = dict(N_layers=2, N_res=1, N_res_neck=1, channel_multiplier=4)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _x(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ndim,n,out", [(1, 32, 64), (1, 64, 24),
                                        (2, 16, 32), (2, 32, 12)])
def test_bicubic_resize_matches_jax(ndim, n, out):
    x = _x(np.random.default_rng(n + out), (2, 3) + (n,) * ndim)
    if ndim == 1:
        want = jinterp.bicubic_resize_1d(jnp.asarray(x), out)
        got = interpolation.bicubic_resize_1d(torch.from_numpy(x), out)
    else:
        want = jinterp.bicubic_resize_2d(jnp.asarray(x), (out, out))
        got = interpolation.bicubic_resize_2d(torch.from_numpy(x),
                                              (out, out))
    assert got.shape == want.shape
    assert _max_rel(got, want) < OPS_TOL


@pytest.mark.parametrize("ndim,n,out", [(1, 32, 32), (1, 32, 16),
                                        (1, 16, 32), (2, 16, 16),
                                        (2, 16, 8), (2, 8, 16)])
def test_cno_lrelu_matches_jax(ndim, n, out):
    x = _x(np.random.default_rng(n * out), (2, 3) + (n,) * ndim)
    jact = jinterp.cno_lrelu_1d if ndim == 1 else jinterp.cno_lrelu_2d
    act = interpolation.cno_lrelu_1d if ndim == 1 else \
        interpolation.cno_lrelu_2d
    want = jact(jnp.asarray(x), n, out)
    got = act(torch.from_numpy(x), n, out)
    assert _max_rel(got, want) < OPS_TOL


@pytest.mark.parametrize("factor,kw", [
    (2, {}), (4, {}), (2, dict(filter_size=4, cutoff_den=2.5,
                               half_width_mult=0.6))])
def test_filter_taps_equal_jax(factor, kw):
    for name in ("design_lowpass_filter", "design_lowpass_filter_2d_radial"):
        got = getattr(filters, name)(factor, **kw)
        want = getattr(jfilters, name)(factor, **kw)
        assert got.dtype == want.dtype == np.float32
        assert got.tobytes() == want.tobytes(), name


@pytest.mark.parametrize("radial", [False, True])
def test_filtered_resampling_matches_jax(radial):
    rng = np.random.default_rng(int(radial))
    x1, x2 = _x(rng, (2, 3, 24)), _x(rng, (2, 3, 16, 16))
    kw = dict(filter_size=6, cutoff_den=2.0001, half_width_mult=0.8)
    cases = [
        ("upsample_1d", (x1, 2), {}), ("downsample_1d", (x1, 2), {}),
        ("upsample_2d", (x2, 2), dict(radial=radial)),
        ("upsample_2d", (x2, 4), dict(radial=radial)),
        ("downsample_2d", (x2, 2), dict(radial=radial)),
        ("filtered_lrelu_2d", (x2,), dict(radial=radial)),
        ("filtered_lrelu_2d", (x2,), dict(radial=radial, out_factor=4))]
    for name, (x, *args), extra in cases:
        want = getattr(jfilters, name)(jnp.asarray(x), *args, **kw, **extra)
        got = getattr(filters, name)(torch.from_numpy(x), *args, **kw,
                                     **extra)
        assert got.shape == want.shape, name
        assert _max_rel(got, want) < OPS_TOL, (name, args, extra)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def random_variables(jmodel, x, seed):
    """Variables of ``jmodel`` drawn with numpy from ``seed`` at the shapes
    flax gives them: kernels at variance 1 / fan-in, biases and norm
    shifts small, norm scales and running variances near 1."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0),
                            jnp.asarray(x[:1]))

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            std = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
            return (std * rng.standard_normal(s.shape)).astype(np.float32)
        if name in ("scale", "var"):
            return (1.0 + 0.2 * rng.random(s.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _feeds_batch_norm(name: str, names) -> bool:
    """A conv bias whose conv a BatchNorm follows."""
    module, leaf = name.rsplit(".", 1)
    prefix, conv = module.rsplit(".", 1) if "." in module else ("", module)
    if leaf != "bias" or not conv.startswith("convolution"):
        return False
    digit = conv[-1] if conv[-1].isdigit() else ""
    bn = f"{prefix}.batch_norm{digit}.weight" if prefix else \
        f"batch_norm{digit}.weight"
    return bn in names


def check_against_jax(jmodel, model, bridge, x, seed):
    """The eval-mode forward against JAX's in float32; the train-mode
    forward, the gradients of sum(y * g) and the updated running
    statistics against JAX's in float64 (flax's BatchNorm backward, with
    its E[x²] - E[x]² variance, loses about 5e-4 over these layers in
    float32, where the port's float32 gradients are within 1e-6 of its
    own float64 ones)."""
    variables = random_variables(jmodel, x, seed)
    model.load_state_dict(bridge(variables))
    with torch.no_grad():
        got_eval = model.eval()(torch.from_numpy(x))
    want_eval = jax.jit(lambda v, x: jmodel.apply(v, x, deterministic=True))(
        variables, jnp.asarray(x))
    assert _rel(got_eval, want_eval) < RTOL
    g = np.random.default_rng(seed + 1).standard_normal(
        got_eval.shape).astype(np.float32)

    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        # the filtered CNO's float32 taps, the same numbers in float64
        for name in ("design_lowpass_filter",
                     "design_lowpass_filter_2d_radial"):
            design = getattr(jfilters, name)
            mp.setattr(jfilters, name,
                       lambda *a, _d=design, **k: _d(*a, **k).astype(
                           np.float64))
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                     variables)

        def loss(params, x):
            y, upd = jmodel.apply({**v64, "params": params}, x,
                                  deterministic=False,
                                  mutable=["batch_stats"])
            return jnp.sum(y * g.astype(np.float64)), (y, upd)

        (_, (want_y, upd)), grads = jax.jit(
            jax.value_and_grad(loss, has_aux=True))(
                v64["params"], jnp.asarray(x, jnp.float64))
        want_y = np.asarray(want_y)
        grads, upd = jax.tree_util.tree_map(np.asarray, (grads, upd))
    model.train().zero_grad()
    got_y = model(torch.from_numpy(x))
    (got_y * torch.from_numpy(g)).sum().backward()
    assert _rel(got_y.detach(), want_y) < RTOL

    want_g = bridge({"params": grads})
    names = set(want_g)
    total = np.sqrt(sum(float(np.sum(np.asarray(v, np.float64) ** 2))
                        for v in want_g.values()))
    for name, p in model.named_parameters():
        if _feeds_batch_norm(name, names):
            assert np.linalg.norm(p.grad.numpy() - want_g[name].numpy()) \
                < RTOL * total, name
        else:
            assert _rel(p.grad, want_g[name]) < RTOL, name

    stats = {k: v for k, v in bridge({"params": variables["params"],
                                      **upd}
                                     ).items() if "running" in k}
    got_stats = {k: v for k, v in model.state_dict().items()
                 if "running" in k}
    assert set(got_stats) == set(stats)
    for k, v in stats.items():
        assert _max_rel(got_stats[k], v) < STATS_TOL, k


def _cno(cls, jcls, ndim, **kw):
    g = torch.Generator().manual_seed(0)
    return (cls(1, 1, 32, **SMALL, **kw, generator=g),
            jcls(1, 1, 32, **SMALL, **kw), ndim)


CASES = {
    "cno1d": lambda: (*_cno(CNO1d, JaxCNO1d, 1),
                      lambda v: jax_bridge.cno1d_state_dict(v, n_res=1)),
    "cno2d": lambda: (*_cno(CNO2d, JaxCNO2d, 2),
                      lambda v: jax_bridge.cno2d_state_dict(v, n_res=1)),
    "cno2d_original": lambda: (
        *_cno(CNO2dOriginal, JaxCNO2dOriginal, 2, latent_lift_proj_dim=8),
        lambda v: jax_bridge.cno2d_original_state_dict(v, n_res=1)),
    "cno2d_original_radial": lambda: (
        *_cno(CNO2dOriginal, JaxCNO2dOriginal, 2, latent_lift_proj_dim=8,
              radial=True),
        lambda v: jax_bridge.cno2d_original_state_dict(v, n_res=1)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cno_matches_jax(case):
    model, jmodel, ndim, bridge = CASES[case]()
    x = _x(np.random.default_rng(len(case)), (3, 1) + (32,) * ndim)
    check_against_jax(jmodel, model, bridge, x, seed=len(case))


@pytest.mark.parametrize("ndim", [1, 2])
def test_bridge_round_trip_through_torch_import(ndim):
    """The port's state_dict through the JAX package's reader of the
    reference's state_dicts and back through the bridge."""
    cls, imp, bridge = ((CNO1d, import_cno1d, jax_bridge.cno1d_state_dict)
                        if ndim == 1 else
                        (CNO2d, import_cno2d, jax_bridge.cno2d_state_dict))
    model = cls(1, 1, 32, **SMALL,
                generator=torch.Generator().manual_seed(ndim))
    with torch.no_grad():
        for name, buf in model.named_buffers():
            buf.add_(torch.rand(buf.shape))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    back = bridge(imp(sd, n_layers=2, n_res=1, n_res_neck=1), n_res=1)
    assert set(back) == set(sd)
    for k, v in back.items():
        assert np.array_equal(v.numpy(), sd[k]), k


def test_init_is_flax_lecun_normal_and_seeded():
    a = CNO2d(1, 1, 32, **SMALL, generator=torch.Generator().manual_seed(3))
    b = CNO2d(1, 1, 32, **SMALL, generator=torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    w = a.res_nets[0].res_nets[0].convolution1.weight
    std = (1.0 / (w.shape[1] * 9)) ** 0.5
    assert float(w.detach().abs().max()) <= 2 * std / 0.87962566103423978
    assert torch.count_nonzero(a.encoder[0].convolution.bias) == 0
    bn = a.encoder[0].batch_norm
    assert torch.equal(bn.running_var, torch.ones_like(bn.running_var))
    assert sorted(dict(bn.named_buffers())) == ["running_mean",
                                                "running_var"]
    assert get_model("models.CNO2d.CNO2d") is CNO2d
    assert get_model("CNO1d") is CNO1d
    assert get_model("CNO.CNO2d_original_version.CNOModule.CNO") \
        is CNO2dOriginal


def test_batch_norm_keeps_the_biased_variance():
    """flax's update: 0.9 old + 0.1 batch, the batch's biased variance
    (torch.nn.BatchNorm1d keeps the unbiased one)."""
    x = torch.from_numpy(_x(np.random.default_rng(0), (4, 3, 5)))
    bn = BatchNorm(3).train()
    bn(x)
    var, mean = torch.var_mean(x, dim=(0, 2), unbiased=False)
    torch.testing.assert_close(bn.running_mean, 0.1 * mean)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var)
    ref = torch.nn.BatchNorm1d(3, momentum=0.1).train()
    ref(x)
    assert not torch.allclose(ref.running_var, bn.running_var)


@pytest.mark.parametrize("ndim,name", [(1, "CNO1d"), (2, "CNO2d")])
def test_wrong_size_raises(ndim, name):
    cls = CNO1d if ndim == 1 else CNO2d
    model = cls(1, 1, 32, **SMALL)
    with pytest.raises(ValueError, match=f"{name} was built for size 32"):
        model(torch.zeros((1, 1) + (16,) * ndim))


def test_rollout_runs_in_eval_mode():
    """A CNO2d left in train mode gives the eval-mode rollout loss, its
    running statistics untouched and its mode given back."""
    model = CNO2d(1, 1, 32, **SMALL, generator=torch.Generator().manual_seed(1))
    traj = _x(np.random.default_rng(2), (3, 4, 32, 32))
    want = rollout_loss(model.eval(), traj, 3, spatial_ndim=2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = rollout_loss(model.train(), traj, 3, spatial_ndim=2)
    assert got == want
    assert model.training
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_checkpoint_resume_repeats_batch_norm_buffers(tmp_path):
    """The Trainer's checkpoint carries the running statistics, and a
    resume repeats the steps, buffers included, bit for bit on the CPU
    (on the card CNO is held to a tolerance: the resize's backward adds
    with atomics there)."""
    from resolution_pde_tpu_torch.train import (Trainer, restore_checkpoint,
                                                save_checkpoint)

    rng = np.random.default_rng(4)
    batches = [(_x(rng, (3, 1, 32, 32)), _x(rng, (3, 1, 32, 32)))
               for _ in range(3)]

    def fresh():
        t = Trainer(CNO2d(1, 1, 32, **SMALL,
                          generator=torch.Generator().manual_seed(5)),
                    device="cpu", accum_steps=2)
        return t, t.init()

    t, state = fresh()
    full = [float(t.train_step(state, x, y)[1]) for x, y in batches]
    want = {k: v.clone() for k, v in state.model.state_dict().items()}
    t, state = fresh()
    t.train_step(state, *batches[0])
    save_checkpoint(str(tmp_path / "ckpt"), state)
    t, state = fresh()
    state, _ = restore_checkpoint(str(tmp_path / "ckpt"), state)
    assert state.step == 1
    resumed = [float(t.train_step(state, x, y)[1]) for x, y in batches[1:]]
    assert resumed == full[1:]
    got = state.model.state_dict()
    assert any("running_var" in k for k in got)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
