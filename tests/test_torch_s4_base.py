"""The port's S4 base and sequence models on the CPU against the JAX
package (models.s4_base, models.io_processors): every io processor,
BatchSpaceConv, S4BaseModel across its per-layer options, S4SeqModel,
OneToSeqModel and predict_chunked, S4BaseSeqModel, S4DualSeqModel (both
modes), SeqAdd and ChainModel, each on the JAX variables carried over by
``utils.jax_bridge.s4_base_state_dict``; their recurrent forms
(s4seq_recurrent_fns, s4dualseq_recurrent_fns, chain_predict) against
JAX's and against the convolution at JAX's own tolerances; the registry
(every model name, ``register``); and ns_window_dataset against JAX's
factory on an .h5 and a .mat file.

Tolerances: relative L2 1e-4 for a model against JAX in f32 (1e-5 for the
processors, pure reshapes, and BatchSpaceConv); the recurrence against
the convolution at rtol 2e-3 / atol 2e-4, as tests/test_s4_base_mgpt.py
holds JAX's; the dataset's raw trajectories exactly, its normalized
windows within 1e-6 (the normalizers' arithmetic rounds differently).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
h5py = pytest.importorskip("h5py")
import jax.numpy as jnp  # noqa: E402
import scipy.io  # noqa: E402

from resolution_pde_tpu.configs import (  # noqa: E402
    instantiate_dataset as jax_dataset)
from resolution_pde_tpu.models import io_processors as jiop  # noqa: E402
from resolution_pde_tpu.models import s4_base as jbase  # noqa: E402
from resolution_pde_tpu_torch import configs as tcfg  # noqa: E402
from resolution_pde_tpu_torch.models import io_processors as iop  # noqa: E402
from resolution_pde_tpu_torch.models import registry, s4_base  # noqa: E402
from resolution_pde_tpu_torch.utils import jax_bridge  # noqa: E402

MODEL = 1e-4
SAME = 1e-5
SEQ_RTOL, SEQ_ATOL = 2e-3, 2e-4  # tests/test_s4_base_mgpt.py:172, 280


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _x(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _grid(b, s):
    return np.broadcast_to(np.linspace(0, 1, s, dtype=np.float32)[None, :,
                                                                  None],
                           (b, s, 1)).copy()


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


# ---------------------------------------------------------------------------
# io processors
# ---------------------------------------------------------------------------

GRID_CASES = {"Concat": (2, 8, 3), "ConcatND": (2, 8, 3),
              "ConcatTransSqueeze1D": (2, 8, 1),
              "ConcatFlatTrans": (2, 8, 5, 3), "ConcatTrans": (2, 8, 5, 3)}


@pytest.mark.parametrize("name", sorted(GRID_CASES))
def test_grid_input_processors_match_jax(name):
    rng = np.random.default_rng(0)
    x, g = _x(rng, GRID_CASES[name]), _x(rng, (2, 8, 1))
    want = jiop.GRID_INPUT_REGISTRY[name](jnp.asarray(x), jnp.asarray(g))
    got = iop.GRID_INPUT_REGISTRY[name](torch.from_numpy(x),
                                        torch.from_numpy(g))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("name", sorted(iop.INPUT_REGISTRY))
def test_input_processors_match_jax(name):
    x = _x(np.random.default_rng(1), (2, 5, 8, 3))
    np.testing.assert_array_equal(
        _np(iop.INPUT_REGISTRY[name](torch.from_numpy(x))),
        np.asarray(jiop.INPUT_REGISTRY[name](jnp.asarray(x))))


OUT_CASES = {  # (the processor's input shape, the input_shape argument)
    "identity": ((2, 5, 3), (2, 5, 3)), "Squeeze": ((2, 5, 1), (2, 5, 1)),
    "Unsqueeze": ((2, 5, 3), (2, 5, 3)),
    "UnflatTrans": ((2, 5, 24), (2, 8, 5, 3)),
    "UnbatchTime": ((10, 8, 3), (2, 5, 8, 3)),
    "UnbatchSpace": ((16, 5, 3), (2, 5, 4, 2, 3)),
    "SpaceFromHidden": ((2, 5, 24), (2, 5, 8, 3)),
    "Trans": ((2, 5, 8, 3), (2, 5, 8, 3)),
}


@pytest.mark.parametrize("name", sorted(OUT_CASES))
def test_output_processors_match_jax(name):
    shape, input_shape = OUT_CASES[name]
    x = _x(np.random.default_rng(2), shape)
    np.testing.assert_array_equal(
        _np(iop.OUTPUT_REGISTRY[name](torch.from_numpy(x), input_shape)),
        np.asarray(jiop.OUTPUT_REGISTRY[name](jnp.asarray(x), input_shape)))


@pytest.mark.parametrize("dim,kernel_size", [(1, 3), (2, 3), (1, 4)])
def test_batch_space_conv_matches_jax(dim, kernel_size):
    x = _x(np.random.default_rng(3), (2, 3) + (6,) * dim + (4,))
    jm = jiop.BatchSpaceConv.make(d_model=5, kernel_size=kernel_size,
                                  dim=dim)
    p = jm.init(jax.random.key(0), jnp.asarray(x))["params"]
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(x)))
    m = iop.BatchSpaceConv(4, 5, kernel_size, dim)
    m.load_state_dict(jax_bridge._conv(p["Conv_0"], "conv"))
    got = _np(m(torch.from_numpy(x)))
    assert got.shape == want.shape == (2 * 6 ** dim, 3, 5)
    assert rel_l2(got, want) <= SAME


# ---------------------------------------------------------------------------
# The models against JAX
# ---------------------------------------------------------------------------

def _pair(jmodel, tmodel, *args):
    """JAX's output on its init, and the port's on the bridged weights."""
    jargs = [jnp.asarray(a) for a in args]
    p = jax.jit(jmodel.init)(jax.random.key(4), *jargs)
    want = np.asarray(jax.jit(jmodel.apply)(p, *jargs))
    tmodel.load_state_dict(jax_bridge.s4_base_state_dict(p, tmodel))
    with torch.no_grad():
        got = _np(tmodel(*[torch.from_numpy(a) for a in args]))
    return got, want, p


BASE_CASES = [
    dict(),
    dict(ffn_type="ffn", residual_type="weighted", prenorm=True,
         mode="dplr"),
    dict(ffn_type=["ffn", "zero"], norm_type=["identity", "LayerNorm"],
         residual_type=["zero", "identity"], interlayer_act="gelu",
         final_mlp_hidden_expansion=2, bidirectional=True),
]


@pytest.mark.parametrize("kw", BASE_CASES, ids=range(len(BASE_CASES)))
def test_s4_base_model_matches_jax(kw):
    cfg = dict(d_input=2, d_output=3, d_model=8, n_layers=2, **kw)
    rng = np.random.default_rng(5)
    got, want, _ = _pair(jbase.S4BaseModel(**cfg), s4_base.S4BaseModel(**cfg),
                         _x(rng, (2, 16, 1)), _grid(2, 16))
    assert got.shape == want.shape == (2, 16, 3)
    assert rel_l2(got, want) <= MODEL


def test_s4_base_model_refusals():
    m = s4_base.S4BaseModel(d_input=3, d_model=8, n_layers=1)
    with pytest.raises(ValueError, match="reads 3 features.*has 2"):
        m(torch.zeros(1, 8, 1), torch.zeros(1, 8, 1))
    with pytest.raises(ValueError, match="unknown residual"):
        s4_base.S4BaseModel(d_input=2, n_layers=1, residual_type="half")
    with pytest.raises(ValueError, match="3 per-layer values for 2"):
        s4_base.S4BaseModel(d_input=2, n_layers=2, ffn_type=["ffn"] * 3)
    with pytest.raises(ValueError, match="unknown layer processor"):
        s4_base.S4DualSeqModel(d_input=1, layer_processors=("Diagonal",))


def _seq(rng, b=2, t=6, s=4, v=1):
    return _x(rng, (b, t, s, v)), _grid(b, s)


SEQ_CASES = [
    ("S4SeqModel", dict(mode="diag")),
    ("S4SeqModel", dict(mode="dplr")),
    ("S4BaseSeqModel", dict(mode="diag", interlayer_act="gelu")),
    ("S4BaseSeqModel", dict(mode="dplr",
                            kernel_args=dict(dt_fast=True))),
    ("S4DualSeqModel", dict(mode="diag")),
    ("S4DualSeqModel", dict(mode="dplr", bidirectional_space=False,
                            layer_processors=("BatchSpace", "BatchTime"))),
]


@pytest.mark.parametrize("name,kw", SEQ_CASES,
                         ids=[f"{n}-{k['mode']}" for n, k in SEQ_CASES])
def test_sequence_models_match_jax(name, kw):
    cfg = dict(d_input=2, d_output=2, d_model=8, n_layers=2, **kw)
    x, g = _seq(np.random.default_rng(6), v=2)
    got, want, _ = _pair(getattr(jbase, name)(**cfg),
                         getattr(s4_base, name)(**cfg), x, g)
    assert got.shape == want.shape == (2, 6, 4, 2)
    assert rel_l2(got, want) <= MODEL


def test_seq_add_and_chain_model_match_jax():
    x, g = _seq(np.random.default_rng(7), t=4)
    cfg = dict(d_input=1, d_output=1, d_model=8, n_layers=1)

    def two(cls):
        return cls(**cfg), cls(**cfg)

    ja, jb = two(jbase.S4BaseSeqModel)
    ta, tb = two(s4_base.S4BaseSeqModel)
    got, want, _ = _pair(jbase.SeqAdd(model1=ja, model2=jb),
                         s4_base.SeqAdd(ta, tb), x, g)
    assert rel_l2(got, want) <= MODEL
    got, want, _ = _pair(jbase.ChainModel(model=ja, chain_length=3),
                         s4_base.ChainModel(ta, chain_length=3), x, g)
    assert got.shape == want.shape == x.shape
    assert rel_l2(got, want) <= MODEL


def test_one_to_seq_and_predict_chunked_match_jax():
    rng = np.random.default_rng(8)
    x0, g = _x(rng, (2, 16, 1)), _grid(2, 16)
    cfg = dict(d_input=2, d_output=1, d_model=8, n_layers=1, n_timesteps=3)
    jm, tm = jbase.OneToSeqModel(**cfg), s4_base.OneToSeqModel(**cfg)
    got, want, p = _pair(jm, tm, x0, g)
    assert got.shape == want.shape == (2, 3, 16, 1)
    assert rel_l2(got, want) <= MODEL

    japply = jax.jit(jm.apply)
    want = jbase.predict_chunked(
        lambda s, gg, steps: japply(p, s, gg)[:, :steps], jnp.asarray(x0),
        jnp.asarray(g), n_timesteps=7, train_timesteps=3, lg_length=2)
    with torch.no_grad():
        got = s4_base.predict_chunked(
            lambda s, gg, steps: tm(s, gg)[:, :steps], torch.from_numpy(x0),
            torch.from_numpy(g), n_timesteps=7, train_timesteps=3,
            lg_length=2)
    assert got.shape == want.shape == (2, 7, 16, 1)
    assert rel_l2(_np(got), want) <= MODEL


# ---------------------------------------------------------------------------
# Recurrent forms
# ---------------------------------------------------------------------------

def _step_over_time(init_state, step, xs, g, flat):
    """Step over T: xs (B, T, S, V), grid (B, S, G); ``flat`` flattens
    space into the batch (the seq models' steps take (B S, V))."""
    b, t, s, v = xs.shape
    if flat:
        xs = xs.movedim(1, 2).reshape(b * s, t, v)
        g = g.reshape(b * s, -1)
    state, ys = init_state(b * s), []
    for k in range(t):
        y, state = step(state, xs[:, k], g)
        ys.append(y)
    y = torch.stack(ys, dim=1)
    return y.reshape(b, s, t, -1).movedim(1, 2) if flat else y


@pytest.mark.parametrize("mode,act,ka", [
    ("diag", None, None), ("dplr", None, None), ("diag", "gelu", None),
    ("diag", None, dict(disc="bilinear", dt_fast=True,
                        dt_transform="softplus")),
])
def test_s4seq_recurrent_matches_conv_and_jax(mode, act, ka):
    b, t, s, v, d = 2, 8, 4, 1, 12
    x, g = _seq(np.random.default_rng(9), b, t, s, v)
    cfg = dict(d_input=v, d_output=1, d_model=d, n_layers=2, mode=mode,
               interlayer_act=act, kernel_args=ka)
    jm, tm = jbase.S4BaseSeqModel(**cfg), s4_base.S4BaseSeqModel(**cfg)
    conv, _, p = _pair(jm, tm, x, g)
    with torch.no_grad():
        rec = _step_over_time(*s4_base.s4seq_recurrent_fns(
            tm, d, 2, mode, L_train=t, interlayer_act=act, kernel_args=ka),
            torch.from_numpy(x), torch.from_numpy(g), flat=True)
    np.testing.assert_allclose(_np(rec), conv, rtol=SEQ_RTOL, atol=SEQ_ATOL)
    init_state, step = jbase.s4seq_recurrent_fns(
        p, d, 2, mode, L_train=t, interlayer_act=act, kernel_args=ka)
    xt = np.moveaxis(x, 1, 2).reshape(b * s, t, v)
    state, ys = init_state(b * s), []
    for k in range(t):
        y, state = step(state, jnp.asarray(xt[:, k]),
                        jnp.asarray(g.reshape(b * s, 1)))
        ys.append(np.asarray(y))
    want = np.moveaxis(np.stack(ys, 1).reshape(b, s, t, 1), 1, 2)
    assert rel_l2(_np(rec), want) <= MODEL


@pytest.mark.parametrize("mode", ["diag", "dplr"])
def test_s4dualseq_recurrent_matches_conv_and_jax(mode):
    b, t, s, v, d = 2, 6, 4, 1, 12
    x, g = _seq(np.random.default_rng(10), b, t, s, v)
    cfg = dict(d_input=v, d_output=1, d_model=d, n_layers=2, mode=mode,
               layer_processors=("BatchTime", "BatchSpace"))
    jm, tm = jbase.S4DualSeqModel(**cfg), s4_base.S4DualSeqModel(**cfg)
    conv, _, p = _pair(jm, tm, x, g)
    with torch.no_grad():
        rec = _step_over_time(*s4_base.s4dualseq_recurrent_fns(
            tm.state_dict(), tm, L_train=t), torch.from_numpy(x),
            torch.from_numpy(g), flat=False)
    np.testing.assert_allclose(_np(rec), conv, rtol=SEQ_RTOL, atol=SEQ_ATOL)
    init_state, step = jbase.s4dualseq_recurrent_fns(p, jm, L_train=t)
    state, ys = init_state(b * s), []
    for k in range(t):
        y, state = step(state, jnp.asarray(x[:, k]), jnp.asarray(g))
        ys.append(np.asarray(y))
    assert rel_l2(_np(rec), np.stack(ys, 1)) <= MODEL


def test_chain_predict_matches_jax():
    b, t, s, v, d = 2, 4, 4, 1, 8
    x, g = _seq(np.random.default_rng(11), b, t, s, v)
    cfg = dict(d_input=v, d_output=v, d_model=d, n_layers=1, mode="diag")
    jinner, tinner = jbase.S4BaseSeqModel(**cfg), s4_base.S4BaseSeqModel(
        **cfg)
    jchain = jbase.ChainModel(model=jinner, chain_length=2)
    tchain = s4_base.ChainModel(tinner, chain_length=2)
    _, _, p = _pair(jchain, tchain, x, g)
    want = np.asarray(jbase.chain_predict(
        p, jinner, jnp.asarray(x[:, 0]), jnp.asarray(g), n_timesteps=7,
        train_timesteps=t, chain_length=2))
    with torch.no_grad():
        for params in (tchain, tchain.state_dict(), tinner.state_dict()):
            got = s4_base.chain_predict(
                params, tinner, torch.from_numpy(x[:, 0]),
                torch.from_numpy(g), n_timesteps=7, train_timesteps=t,
                chain_length=2)
            assert got.shape == want.shape == (b, 7, s, v)
            assert rel_l2(_np(got), want) <= MODEL


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

ITEM5 = {"S4NDModel": "models.s4_2d.S4NDModel",
         "S4BaseModel": "models.s4_model.S4BaseModel",
         "S4SeqModel": "models.s4seq_model.S4SeqModel",
         "OneToSeqModel": "models.s4seq_model.OneToSeqModel",
         "S4BaseSeqModel": "models.s4seq_model.S4BaseSeqModel",
         "S4DualSeqModel": "models.s4seq_model.S4DualSeqModel",
         "SeqAdd": "models.s4seq_model.SeqAdd",
         "ChainModel": "models.s4seq_model.ChainModel"}


def test_registry_resolves_every_jax_model():
    from resolution_pde_tpu.models import registry as jreg

    for name, dotted in ITEM5.items():
        assert registry.get_model(name) is registry.get_model(dotted)
        assert registry.get_model(name).__name__ == name
    assert set(jreg.MODEL_REGISTRY) <= set(registry.MODEL_REGISTRY)
    assert registry.NOT_PORTED == {} and tcfg.NOT_PORTED == {}
    with pytest.raises(KeyError, match="unknown model"):
        registry.get_model("models.nope.NoSuchModel")


def test_register_as_decorator_and_call(monkeypatch):
    monkeypatch.setattr(registry, "MODEL_REGISTRY",
                        dict(registry.MODEL_REGISTRY))

    @registry.register("models.custom.TinyOperator")
    class TinyOperator(torch.nn.Module):
        pass

    assert registry.get_model("models.custom.TinyOperator") is TinyOperator
    # a dotted path ending in a registered short name resolves to it
    assert registry.register("Tiny2", TinyOperator) is TinyOperator
    assert registry.get_model("some.where.Tiny2") is TinyOperator
    assert tcfg.model_kwargs({"_target_": "models.custom.TinyOperator"})[
        0] is TinyOperator


# ---------------------------------------------------------------------------
# ns_window_dataset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ext", ["h5", "mat"])
def test_ns_window_dataset_matches_jax(tmp_path, ext):
    u = np.random.default_rng(12).standard_normal((10, 7, 8, 8)).astype(
        np.float32)
    name = f"ns.{ext}"
    if ext == "h5":
        with h5py.File(tmp_path / name, "w") as f:
            f.create_dataset("u", data=u)
    else:
        scipy.io.savemat(tmp_path / name, {"u": u})
    params = {"_target_": "dataloaders.ns_s4.ns_window_dataset",
              "filename": name, "saved_folder": str(tmp_path),
              "window_size": 3, "reduced_resolution": 2}
    want = jax_dataset(dict(params))
    for target in ("dataloaders.ns_s4.ns_window_dataset",
                   "ns_window_dataset"):
        got = tcfg.instantiate_dataset(dict(params, _target_=target))
        assert len(got) == len(want) == 6
        for split in range(3):
            assert got[split].x.shape == (len(want[split].x), 3, 4, 4)
            for attr in ("x", "y"):
                np.testing.assert_allclose(getattr(got[split], attr),
                                           getattr(want[split], attr),
                                           rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(np.asarray(got[3].u),
                                      np.asarray(want[3].u))
        for k in (4, 5):
            for attr in ("mean", "std"):
                np.testing.assert_allclose(
                    np.asarray(getattr(got[k], attr)),
                    np.asarray(getattr(want[k], attr)), rtol=1e-6)
