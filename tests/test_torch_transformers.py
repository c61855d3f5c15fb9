"""The port's transformer operators against the JAX package's on the CPU:
SwinOperator2d's window attention and the whole operator (also on a grid
its patch does not divide: flax's SAME padding), ScOT's SwinV2 window
attention and blocks (unshifted, shifted with its mask, and with the
window clamped to the grid and the shift dropped), CondLayerNorm with
non-zero conditioning and without any, PatchMerging, PatchExpanding,
ConvNeXtBlock and the whole ScOT2d (two stages on a grid whose first
stage shifts and whose second clamps), each on the JAX variables carried
over by utils.jax_bridge: the forward, and every parameter's gradient of
a weighted sum of the output, at a time other than 1 (a scalar and one a
sample). The JAX parameters are seeded draws in the tree of the JAX
module (``_params``), so that the conditioning (alpha, beta, zero at
init) and the layer scale (gamma, 1e-6 at init) matter. The window
constants (log-CPB table, relative-position index, shift masks) equal
JAX's byte for byte. Then ``main_2d model=pos`` at a tiny width through
both command lines, from the same initial weights.

Tolerance: relative L2 1e-4 in f32 on the outputs and on each
parameter's gradient (a parameter whose JAX gradient is below 1e-6 of
the whole gradient's norm is held to 1e-4 of that norm instead); the
command lines' losses, sweep and rollout 1e-4 relative.
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
from resolution_pde_tpu.models import poseidon as jpos  # noqa: E402
from resolution_pde_tpu_torch.cli import common  # noqa: E402
from resolution_pde_tpu_torch.cli.main_2d import main  # noqa: E402
from resolution_pde_tpu_torch.configs import parse_cli  # noqa: E402
from resolution_pde_tpu_torch.models import get_model, poseidon  # noqa: E402
from resolution_pde_tpu_torch.train import save_checkpoint  # noqa: E402
from resolution_pde_tpu_torch.utils import jax_bridge  # noqa: E402

RTOL = 1e-4
JAX_DEVICES = 8  # tests/conftest.py


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _x(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _params(jmod, seed: int, *args):
    """Seeded parameters in the JAX module's tree, from its shapes
    (jax.eval_shape of its init, which is not run): kernels normal over
    sqrt(fan_in), LayerNorm scales 1 + noise, the logit scale log 10 +
    noise, every other leaf noise, so that the zero-initialised
    conditioning (alpha, beta) and the layer scale (gamma) matter."""
    shapes = jax.eval_shape(jmod.init, jax.random.key(0), *args)["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        z = _x(rng, s.shape)
        name = path[-1].key
        if name == "kernel":
            return z / np.float32(np.sqrt(np.prod(s.shape[:-1])))
        if name == "scale":
            return 1 + 0.1 * z
        if name == "logit_scale":
            return np.float32(np.log(10.0)) + 0.1 * z
        return 0.1 * z

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _out(y):
    return y["output"] if isinstance(y, dict) else y


def check_against_jax(jmod, params, jargs, port, to_state_dict, pargs,
                      seed: int = 0):
    """The port module on ``to_state_dict(params)`` against the JAX module:
    the forward, and the gradient of sum(out * w) for every parameter."""
    shape = jax.eval_shape(lambda p: _out(jmod.apply({"params": p},
                                                      *jargs)), params).shape
    w = _x(np.random.default_rng(seed + 100), shape)

    def loss(p):
        y = _out(jmod.apply({"params": p}, *jargs))
        return jnp.sum(y * w), y

    # one compiled program for the forward and the gradient
    (_, want), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    want = np.asarray(want)
    # a gradient tree has the params' structure: the bridge maps it
    jgrads = {k: v.numpy().astype(np.float64)
              for k, v in to_state_dict(jgrads).items()}
    port.load_state_dict(to_state_dict(params))
    got = _out(port(*pargs))
    assert got.shape == want.shape
    assert _rel(got.detach(), want) < RTOL
    (got * torch.from_numpy(w)).sum().backward()
    grads = dict(port.named_parameters())
    assert sorted(grads) == sorted(jgrads)
    total = np.sqrt(sum(float(np.sum(np.square(g, dtype=np.float64)))
                        for g in jgrads.values()))
    for name, g in jgrads.items():
        err = np.linalg.norm(np.asarray(grads[name].grad, np.float64) - g)
        assert err <= RTOL * max(np.linalg.norm(g), 1e-6 * total), name


# ---------------------------------------------------------------------------
# SwinOperator2d
# ---------------------------------------------------------------------------

def test_window_attention_matches_jax():
    rng = np.random.default_rng(1)
    x = _x(rng, (6, 16, 12))
    jmod = jpos._WindowAttention(12, 3, 4)
    params = _params(jmod, 1, x)
    port = poseidon._WindowAttention(12, 3, 4)

    def sd(p):
        out = {"rel_bias": jax_bridge._t(p["rel_bias"])}
        out.update(jax_bridge._dense(p["Dense_0"], "qkv"))
        out.update(jax_bridge._dense(p["Dense_1"], "proj"))
        return out

    check_against_jax(jmod, params, (x,), port, sd, (torch.from_numpy(x),))


# the second case's 14² grid does not divide by its patch: flax's SAME
# padding of the patch conv, then the de-embedding cropped back to 14²
@pytest.mark.parametrize("time,size,patch", [(0.5, 16, 2),
                                             ("per_sample", 14, 4)])
def test_swin_operator2d_matches_jax(time, size, patch):
    rng = np.random.default_rng(2)
    x = _x(rng, (2, 1, size, size))
    t = np.array([0.3, 1.7], np.float32) if time == "per_sample" else time
    cfg = dict(in_channels=1, out_channels=1, embed_dim=16, depths=(2,),
               n_heads=2, window_size=4, patch_size=patch)
    jmod = jpos.SwinOperator2d(**cfg)
    params = _params(jmod, 2, x, 1.0)
    port = poseidon.SwinOperator2d(**cfg)
    pt = torch.from_numpy(t) if isinstance(t, np.ndarray) else t
    check_against_jax(jmod, params, (x, t), port,
                      jax_bridge.swin_operator2d_state_dict,
                      (torch.from_numpy(x), pt))


def test_swin_de_embedding_flips_a_nonsymmetric_kernel():
    """flax's ConvTranspose and torch's differ by a spatial flip: the
    bridge's de_embed on a non-symmetric kernel reproduces flax's."""
    import flax.linen as fnn

    rng = np.random.default_rng(3)
    x = _x(rng, (2, 3, 3, 5))
    kernel = _x(rng, (4, 4, 5, 6))
    assert not np.allclose(kernel, kernel[::-1, ::-1])
    p = {"kernel": kernel, "bias": _x(rng, (6,))}
    want = fnn.ConvTranspose(6, (4, 4), strides=(4, 4)).apply(
        {"params": p}, x)
    m = torch.nn.ConvTranspose2d(5, 6, 4, stride=4)
    m.load_state_dict({k.split(".", 1)[1]: v for k, v in
                       jax_bridge._conv_transpose(p, "m").items()})
    got = m(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert _rel(got.detach(), want) < RTOL


# ---------------------------------------------------------------------------
# ScOT's parts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ws", [1, 4, 8])
def test_window_constants_equal_jax(ws):
    assert (poseidon._log_cpb_table(ws).tobytes()
            == jpos._log_cpb_table(ws).tobytes())
    assert np.array_equal(poseidon._rel_position_index(ws),
                          jpos._rel_position_index(ws))
    if ws > 1:
        for h, w in ((2 * ws, 2 * ws), (2 * ws, 3 * ws)):
            assert (poseidon._shift_attention_mask(h, w, ws, ws // 2)
                    .tobytes() == jpos._shift_attention_mask(
                        h, w, ws, ws // 2).tobytes())


def test_swinv2_window_attention_with_mask_matches_jax():
    rng = np.random.default_rng(4)
    b, h, w, c, ws = 2, 8, 8, 12, 4
    mask = jpos._shift_attention_mask(h, w, ws, 2)
    x = _x(rng, (b * mask.shape[0], ws * ws, c))
    jmod = jpos.Swinv2WindowAttention(c, 3, ws)
    params = _params(jmod, 4, x, mask)

    class Port(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.attention = poseidon.Swinv2WindowAttention(c, 3)

        def forward(self, x):
            return self.attention(x, ws, torch.from_numpy(mask))

    check_against_jax(
        jmod, params, (x, mask), Port(),
        lambda p: jax_bridge.swinv2_attention_state_dict(p, "attention"),
        (torch.from_numpy(x),))


# (grid, window, shift): unshifted; shifted with its mask; the window
# clamped to a 4x4 grid and the shift dropped
@pytest.mark.parametrize("grid,window,shift", [(8, 4, 0), (8, 4, 2),
                                               (4, 8, 4)],
                         ids=["unshifted", "shifted", "clamped"])
def test_swinv2_block_matches_jax(grid, window, shift):
    rng = np.random.default_rng(grid + window + shift)
    x = _x(rng, (2, grid, grid, 12))
    temb = np.array([[0.5], [1.5]], np.float32)
    cfg = dict(num_heads=3, window_size=window, shift=shift)
    jmod = jpos.Swinv2Block(12, **cfg)
    params = _params(jmod, 5, x, temb)
    port = poseidon.Swinv2Block(12, **cfg)
    check_against_jax(jmod, params, (x, temb), port,
                      jax_bridge.swinv2_block_state_dict,
                      (torch.from_numpy(x), torch.from_numpy(temb)))


@pytest.mark.parametrize("conditioned", [True, False])
def test_cond_layer_norm_matches_jax(conditioned):
    rng = np.random.default_rng(6)
    x = _x(rng, (2, 4, 4, 8))
    temb = np.array([[0.25], [2.0]], np.float32)
    jmod = jpos.CondLayerNorm(eps=1e-5, use_conditioning=conditioned)
    params = _params(jmod, 6, x, temb)
    assert ("alpha" in params) == conditioned
    if conditioned:
        assert np.abs(params["alpha"]["kernel"]).min() > 0
    port = poseidon.CondLayerNorm(8, eps=1e-5, use_conditioning=conditioned)
    check_against_jax(jmod, params, (x, temb), port,
                      lambda p: {k.split(".", 1)[1]: v for k, v in
                                 jax_bridge._cond_layer_norm(p, "x").items()},
                      (torch.from_numpy(x), torch.from_numpy(temb)))


@pytest.mark.parametrize("part", ["merging", "expanding"])
def test_patch_merging_and_expanding_match_jax(part):
    rng = np.random.default_rng(7)
    x = _x(rng, (2, 4, 6, 8))
    jcls, pcls, lin = ((jpos.PatchMerging, poseidon.PatchMerging,
                        "reduction") if part == "merging" else
                       (jpos.PatchExpanding, poseidon.PatchExpanding,
                        "expansion"))
    jmod = jcls(1e-5)
    params = _params(jmod, 7, x)

    def sd(p):
        out = jax_bridge._dense(p[lin], lin)
        out.update(jax_bridge._norm(p["norm"], None, "norm"))
        return out

    check_against_jax(jmod, params, (x,), pcls(8, 1e-5), sd,
                      (torch.from_numpy(x),))


def test_convnext_block_matches_jax():
    rng = np.random.default_rng(8)
    x = _x(rng, (2, 8, 8, 6))
    temb = np.array([[0.5], [1.5]], np.float32)
    jmod = jpos.ConvNeXtBlock(1e-5)
    params = _params(jmod, 8, x, temb)
    check_against_jax(jmod, params, (x, temb),
                      poseidon.ConvNeXtBlock(6, 1e-5),
                      jax_bridge.convnext_block_state_dict,
                      (torch.from_numpy(x), torch.from_numpy(temb)))


# ---------------------------------------------------------------------------
# ScOT2d
# ---------------------------------------------------------------------------

# two stages on 16² with patch 2: the first (8²) shifts by 2 with its
# mask, the second (4²) has its window clamped and no shift
SCOT = dict(num_channels=1, num_out_channels=1, patch_size=2, embed_dim=16,
            depths=(2, 2), num_heads=(2, 4), skip_connections=(2, 0),
            window_size=4)


@pytest.mark.parametrize("time,extra", [
    (0.5, {}), ("per_sample", dict(learn_residual=True))],
    ids=["scalar", "per_sample_residual"])
def test_scot2d_matches_jax(time, extra):
    rng = np.random.default_rng(9)
    x = _x(rng, (2, 1, 16, 16))
    t = np.array([0.3, 1.7], np.float32) if time == "per_sample" else time
    cfg = dict(SCOT, **extra)
    jmod = jpos.ScOT2d(**cfg)
    params = _params(jmod, 9, x, 1.0)
    port = poseidon.ScOT2d(**cfg)
    pt = torch.from_numpy(t) if isinstance(t, np.ndarray) else t
    check_against_jax(jmod, params, (x, t), port,
                      jax_bridge.scot2d_state_dict,
                      (torch.from_numpy(x), pt))


def test_scot2d_widths_registry_and_pretrained_gate():
    """pos.yaml's ScOT at one input channel has JAX's 101.3 M parameters
    (jax.eval_shape), the sweep's demo 0.48 M; the registry names; the
    pretrained loader raises as JAX's without scOT."""
    def count_jax(**kw):
        shapes = jax.eval_shape(jpos.ScOT2d(**kw).init, jax.random.key(0),
                                jnp.zeros((1, 1, 32, 32)), 1.0)
        return sum(int(np.prod(v.shape))
                   for v in jax.tree_util.tree_leaves(shapes))

    demo = dict(num_channels=1, num_out_channels=1, embed_dim=48,
                depths=(2, 2), num_heads=(3, 6), skip_connections=(2, 0),
                window_size=8)
    counts = []
    for kw in (dict(num_channels=1, num_out_channels=1), demo):
        with torch.device("meta"):  # shapes only
            port = poseidon.ScOT2d(**kw)
        counts.append(sum(p.numel() for p in port.parameters()))
        assert counts[-1] == count_jax(**kw)
    assert round(counts[0] / 1e6, 1) == 101.3
    assert round(counts[1] / 1e6, 2) == 0.48
    for name in ("pos", "ScOT2d", "scOT.model.ScOT"):
        assert get_model(name) is poseidon.ScOT2d
    assert get_model("SwinOperator2d") is poseidon.SwinOperator2d
    with pytest.raises(ImportError, match="scOT"):
        poseidon.load_pretrained_poseidon()


# ---------------------------------------------------------------------------
# main_2d model=pos
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
    d = tmp_path_factory.mktemp("pos_cli")
    rng = np.random.default_rng(11)
    f = np.fft.rfft2(rng.standard_normal((10, 32, 32)))
    f[:, 5:-5, :] = 0
    f[:, :, 5:] = 0
    base = np.fft.irfft2(f, s=(32, 32)).astype(np.float32)
    u = np.stack([np.roll(base, i, axis=-1) for i in range(5)], axis=1)
    with h5py.File(d / "ns.h5", "w") as fh:
        fh.create_dataset("u", data=u)
    return d


def _pos_argv(d, *extra):
    return ["model=pos", "dataset=ns_naive",
            f"dataset.dataset_params.saved_folder={d}",
            "dataset.dataset_params.filename=ns.h5",
            "dataset.original_res=32", "dataset.max_test_resolution=32",
            "dataset.rollout_steps=1", "model.num_channels=1",
            "model.num_out_channels=1", "model.embed_dim=8",
            "model.depths=[2,2]", "model.num_heads=[2,2]",
            "model.skip_connections=[1,0]", "model.window_size=4",
            "training.learning_rate=1e-4", *extra]


def port_checkpoint_of_jax_init(argv, sample_shape, to_state_dict, path):
    """JAX's command line's initial parameters (``Trainer.init``: its
    model's init under jax.random.key(training.seed) on a sample of the
    training inputs, whose values flax's initialisers do not read) as the
    port's checkpoint at ``path``, for ``dataset.saved_checkpoint_path``."""
    from resolution_pde_tpu.configs import instantiate_model, parse_cli \
        as jax_parse_cli

    jcfg = jax_parse_cli(argv)
    variables = jax.jit(instantiate_model(jcfg.model).init)(
        jax.random.key(jcfg.training.get("seed", 0)),
        jnp.zeros(sample_shape))
    cfg = parse_cli(argv)
    model = common.build_model(cfg)
    model.load_state_dict(to_state_dict(variables["params"]))
    save_checkpoint(path, common.build_trainer(cfg, model, None,
                                               device="cpu").init())
    return path


def test_main_2d_pos_matches_jax(ns_dir, tmp_path, monkeypatch):
    """main_2d model=pos (ScOT at embed 8, 2 stages, window 4: at 32² the
    first stage's 8² grid shifts, the second's clamps), 2 epochs at a
    learning rate of 1e-4 from JAX's initial weights, against JAX's
    main_2d: the loss history, test loss, sweep and a one-step rollout.
    Two settings keep f32 roundoff below the tolerance, and why: at init
    this ScOT's f32 gradients are within about 2e-4 of float64 on either
    side, and Adam's first steps move each weight by the learning rate
    whatever its gradient's size, so the runs part in proportion to the
    rate (at 1e-3 by 6e-4 in the test loss after 2 epochs); and the
    untrained ScOT fed its own output amplifies a relative change of its
    input about 40-fold (JAX's own, measured on the CPU), so a second
    rollout step turns the first step's 5e-6 into 2e-4."""
    monkeypatch.delenv("SLURM_JOB_ID", raising=False)
    init = port_checkpoint_of_jax_init(
        _pos_argv(ns_dir), (2, 1, 32, 32), jax_bridge.scot2d_state_dict,
        str(tmp_path / "port_init"))
    run = ["training.epochs=2"]
    with _cwd(tmp_path / "jax"):
        want = jax_main(_pos_argv(ns_dir, *run, "training.batch_size=2"))
    with _cwd(tmp_path / "port"):
        got = main(_pos_argv(ns_dir, *run,
                             f"training.batch_size={2 * JAX_DEVICES}",
                             f"dataset.saved_checkpoint_path={init}"),
                   device="cpu")
    for k in ("train_loss", "val_loss", "lr"):
        np.testing.assert_allclose(getattr(got["history"], k),
                                   getattr(want["history"], k), rtol=RTOL)
    assert got["history"].train_loss[1] < got["history"].train_loss[0]
    assert got["test_loss"] == pytest.approx(want["test_loss"], rel=RTOL)
    for key in ("super_resolution", "rollout"):
        assert sorted(got[key]) == sorted(want[key]) == [32]
        assert got[key][32] == pytest.approx(want[key][32], rel=RTOL), key
    assert got["n_params"] == want["n_params"]
