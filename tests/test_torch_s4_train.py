"""The S4 family's path from training to serving on the CPU, against the
JAX package on the same weights and data (made with numpy from a seed):
the Trainer's ``ssm_lr`` groups, the KS file reader and the window dataset,
the window rollout, the asynchronous checkpoint save, ``profile_step``,
``ServingEngine.from_checkpoint`` and ``cost_summary``.

Tolerances: the loss trajectory and the parameters after 6 AdamW steps,
and the window rollout, within 1e-4 relative (f32; the two optimizers and
FFT implementations round differently); the reader, the windows and the
normalizer statistics exactly, or to float32 rounding for the statistics
(numpy and torch sum in other orders); checkpoints and engines on the
same weights bit for bit.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
h5py = pytest.importorskip("h5py")
import jax.numpy as jnp  # noqa: E402

from resolution_pde_tpu.data import factories as jfac  # noqa: E402
from resolution_pde_tpu.data import io as jio  # noqa: E402
from resolution_pde_tpu.evaluation import rollout as jroll  # noqa: E402
from resolution_pde_tpu.models.s4 import S4Model as JaxS4Model  # noqa: E402
from resolution_pde_tpu.ops.normalizers import (  # noqa: E402
    SimpleNormalizer as JaxNorm)
from resolution_pde_tpu.parallel.mesh import make_mesh  # noqa: E402
from resolution_pde_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from resolution_pde_tpu_torch.configs import dataset_factory  # noqa: E402
from resolution_pde_tpu_torch.data import factories as tfac  # noqa: E402
from resolution_pde_tpu_torch.data import io as tio  # noqa: E402
from resolution_pde_tpu_torch.deploy import ServingEngine  # noqa: E402
from resolution_pde_tpu_torch.evaluation import rollout as troll  # noqa: E402
from resolution_pde_tpu_torch.models import FFNO2D  # noqa: E402
from resolution_pde_tpu_torch.models.s4 import S4Model  # noqa: E402
from resolution_pde_tpu_torch.ops.normalizers import SimpleNormalizer  # noqa: E402
from resolution_pde_tpu_torch.train import (Trainer,  # noqa: E402
                                            restore_checkpoint,
                                            save_checkpoint,
                                            wait_for_checkpoints)
from resolution_pde_tpu_torch.utils.jax_bridge import s4_model_state_dict  # noqa: E402

RTOL = 1e-4
W = 4  # the window (the model's d_input)


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _trajectories(n, t, s, seed=0):
    """Smooth fields (6 Fourier modes) under a per-mode phase and decay a
    frame: a linear evolution a window can learn."""
    rng = np.random.default_rng(seed)
    k = np.arange(s // 2 + 1)
    coef = (rng.standard_normal((n, s // 2 + 1))
            + 1j * rng.standard_normal((n, s // 2 + 1))) * (k < 6)
    step = np.exp(-0.3j * k - 0.02 * k ** 2)
    u = np.stack([np.fft.irfft(coef * step ** i, n=s) for i in range(t)],
                 axis=1)
    return (u * 4 + 0.5).astype(np.float32)


# -- Trainer(ssm_lr) -------------------------------------------------------

@pytest.mark.parametrize("mode", ["diag", "dplr"])
def test_s4_ssm_lr_trajectory_matches_jax_trainer(mode):
    """6 AdamW steps of S4Model (jnp route) with lr 1e-3 and ssm_lr 2.5e-4,
    the rate set to 5e-4 after step 3: per-step losses and the parameters
    after 6 steps within 1e-4 relative of JAX's Trainer, and the
    state-space group at a quarter of the main rate throughout."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 2, 32)).astype(np.float32)
    y = np.roll(x[:, :1], 2, axis=-1)
    kw = dict(d_input=2, d_output=1, d_model=8, n_layers=1, dropout=0.0,
              mode=mode)
    jtrainer = JaxTrainer(JaxS4Model(**kw), learning_rate=1e-3,
                          weight_decay=0.1, ssm_lr=2.5e-4,
                          mesh=make_mesh(devices=jax.devices()[:1]))
    jstate = jtrainer.init(x[:1])
    model = S4Model(**kw, kernel_impl="jnp", device="cpu")
    model.load_state_dict(s4_model_state_dict(jstate.params))
    trainer = Trainer(model, learning_rate=1e-3, weight_decay=0.1,
                      ssm_lr=2.5e-4, device="cpu")
    state = trainer.init()
    want, got = [], []
    for i in range(6):
        if i == 3:
            jstate = jtrainer.set_lr(jstate, 5e-4)
            state = trainer.set_lr(state, 5e-4)
        main_lr, ssm_lr = [g["lr"] for g in state.optimizer.param_groups]
        assert ssm_lr == pytest.approx(0.25 * main_lr, rel=1e-12)
        assert trainer.current_lr(state) == pytest.approx(
            jtrainer.current_lr(jstate), rel=1e-7)  # JAX keeps it in f32
        jstate, jl = jtrainer._train_step(jstate, jnp.asarray(x),
                                          jnp.asarray(y), None)
        want.append(float(jl))
        state, loss = trainer.train_step(state, x, y)
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    ref = s4_model_state_dict(jstate.params)
    for name, p in state.model.state_dict().items():
        assert rel_l2(p, ref[name]) <= RTOL, name


def test_ssm_lr_above_lr_clamps_to_the_main_rate():
    """min(ssm_lr, lr): an ssm_lr above the rate trains at the rate."""
    model = S4Model(d_input=1, d_model=4, n_layers=1, dropout=0.0,
                    generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, learning_rate=1e-3, ssm_lr=1e-2, device="cpu")
    state = trainer.init()
    assert [g["lr"] for g in state.optimizer.param_groups] == [1e-3, 1e-3]


# -- KS files and the window dataset --------------------------------------

@pytest.fixture(scope="module")
def ks_dir(tmp_path_factory):
    """KS files as the generator writes them: a split group (train and
    valid named, test as a file's only group) holding 'pde_<t>-<s>', 'x'
    (2D, as some files store it) and 't'."""
    d = tmp_path_factory.mktemp("ks")
    for i, (fname, group) in enumerate((("KS_train.h5", "train"),
                                        ("KS_valid.h5", "valid"),
                                        ("KS_test.h5", "data"))):
        u = _trajectories(5, 10, 32, seed=i)
        with h5py.File(d / fname, "w") as f:
            g = f.create_group(group)
            g.create_dataset("pde_10-32", data=u)
            g.create_dataset("x", data=np.linspace(0, 1, 32)[None]
                             .repeat(5, 0).astype(np.float32))
            g.create_dataset("t", data=np.arange(10, dtype=np.float32))
    return d


@pytest.mark.parametrize("fname", ["KS_train.h5", "KS_valid.h5",
                                   "KS_test.h5"])
def test_read_ks_h5_matches_jax(ks_dir, fname):
    got, want = tio.read_ks_h5(str(ks_dir / fname)), jio.read_ks_h5(
        str(ks_dir / fname))
    assert sorted(got) == ["t", "u", "x"]
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["x"].shape == (32,)
    assert tio.split_from_filename(fname) == jio.split_from_filename(fname)


def test_ks_reader_refuses_files_without_pde_data(tmp_path):
    with h5py.File(tmp_path / "bad.h5", "w") as f:
        f.create_group("train").create_dataset("u", data=np.zeros((1, 2, 3)))
    with pytest.raises(ValueError, match="no PDE data key"):
        tio.read_ks_h5(str(tmp_path / "bad.h5"))


@pytest.mark.parametrize("red", [dict(), dict(reduced_resolution=2,
                                              reduced_batch=2)])
def test_ks_window_dataset_matches_jax(ks_dir, red):
    kw = dict(filename="KS_train.h5", saved_folder=str(ks_dir),
              window_size=W, val_filename="KS_valid.h5",
              test_filename="KS_test.h5", **red)
    raw = tfac.ks_window_dataset(**kw, data_normalizer=False)
    raw_want = jfac.ks_window_dataset(**kw, data_normalizer=False)
    assert raw[4] is None and raw[5] is None
    for g, w in zip(raw[:3], raw_want[:3]):
        np.testing.assert_array_equal(g.x, w.x)
        np.testing.assert_array_equal(g.y, w.y)
        assert g.x.shape[1] == W and g.y.ndim == 2  # no channel axis
    got = dataset_factory("ks_window_dataset")(**kw)
    want = jfac.ks_window_dataset(**kw)
    assert len(got) == len(want) == 6
    np.testing.assert_array_equal(got[3].u, want[3].u)
    for g, w in zip(got[4:], want[4:]):
        np.testing.assert_allclose(float(g.mean), float(w.mean), rtol=1e-5)
        np.testing.assert_allclose(float(g.std), float(w.std), rtol=1e-5)
    # the splits encoded with those statistics: float32 rounding apart
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.x, w.x, rtol=1e-5, atol=2e-6)
        np.testing.assert_allclose(g.y, w.y, rtol=1e-5, atol=2e-6)


# -- the window rollout ------------------------------------------------------

@pytest.fixture(scope="module")
def window_model():
    jm = JaxS4Model(d_input=W, d_output=1, d_model=8, n_layers=2,
                    dropout=0.0, mode="diag")
    variables = jm.init(jax.random.key(3), jnp.zeros((1, W, 32)))
    model = S4Model(d_input=W, d_output=1, d_model=8, n_layers=2,
                    dropout=0.0, mode="diag", device="cpu")
    model.load_state_dict(s4_model_state_dict(variables))
    traj = _trajectories(5, 12, 32, seed=7)
    norms = dict(jax=(JaxNorm(np.float32(0.4), np.float32(2.5)),
                      JaxNorm(np.float32(0.6), np.float32(2.2))),
                 torch=(SimpleNormalizer(0.4, 2.5), SimpleNormalizer(0.6, 2.2)))
    return jm, variables, model, traj, norms


def test_perform_window_rollout_matches_jax(window_model):
    jm, variables, model, traj, norms = window_model
    win = traj[:3, :W]
    want = jroll.perform_window_rollout(jm, variables, jnp.asarray(win), 5,
                                        *norms["jax"])
    with torch.no_grad():
        got = troll.perform_window_rollout(model.eval(),
                                           torch.from_numpy(win), 5,
                                           *norms["torch"])
    assert got.shape == (3, 5, 1, 32)
    assert rel_l2(got, want) <= RTOL


def test_window_rollout_all_resolutions_matches_jax(window_model):
    """The window route of evaluate_rollout_all_resolutions at 16 and 32
    points, per-step losses included, batches of 2 over 5 trajectories;
    and window_rollout_loss without normalizers."""
    jm, variables, model, traj, norms = window_model

    def builder(res):
        return traj[..., :: 32 // res]

    kw = dict(current_res=32, test_resolutions=[16, 32], rollout_steps=10,
              batch_size=2, window_size=W, strict=True)
    want_steps, got_steps, seconds = {}, {}, {}
    want = jroll.evaluate_rollout_all_resolutions(
        jm, variables, builder, x_normalizer=norms["jax"][0],
        y_normalizer=norms["jax"][1], per_step_out=want_steps, **kw)
    got = troll.evaluate_rollout_all_resolutions(
        model, builder, x_normalizer=norms["torch"][0],
        y_normalizer=norms["torch"][1], per_step_out=got_steps,
        seconds_out=seconds, **kw)
    assert sorted(got) == sorted(seconds) == [16, 32]
    for r in (16, 32):
        # 12 frames seed a window of 4 and roll out 8 of the 10 steps
        assert len(got_steps[r]) == 8
        assert got[r] == pytest.approx(want[r], rel=RTOL)
        np.testing.assert_allclose(got_steps[r], want_steps[r], rtol=RTOL)
    got = troll.window_rollout_loss(model, traj, 3, W, batch_size=4)
    want = jroll.window_rollout_loss(jm, variables, traj, 3, W, batch_size=4)
    assert got == pytest.approx(want, rel=RTOL)


def test_window_rollout_edge_cases(window_model):
    _, _, model, traj, _ = window_model
    per_step = []
    with pytest.warns(UserWarning, match="empty"):
        assert np.isnan(troll.window_rollout_loss(
            model, traj[:0], 3, W, per_step_losses=per_step))
    assert len(per_step) == 3 and np.isnan(per_step).all()
    with pytest.raises(ValueError, match="cannot seed a window"):
        troll.window_rollout_loss(model, traj[:, :W], 3, W)
    out = troll.evaluate_rollout_all_resolutions(
        model, lambda r: traj[:, :W], current_res=32, test_resolutions=[32],
        window_size=W)
    assert np.isnan(out[32])


# -- checkpoints, profile_step ----------------------------------------------

def _s4(mode="dplr", kernel_impl="jnp", seed=0):
    return S4Model(d_input=3, d_output=1, d_model=8, n_layers=2,
                   dropout=0.1, mode=mode, kernel_impl=kernel_impl,
                   device="cpu", generator=torch.Generator().manual_seed(seed))


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.standard_normal((4, 3, 16)).astype(np.float32)
        out.append((x, np.roll(x[:, :1], 1, axis=-1)))
    return out


def test_async_save_restores_the_state_at_the_save(tmp_path):
    """block=False, then steps that update every tensor in place: the
    checkpoint holds the state at the save, bit for bit (parameters,
    AdamW moments, step, dropout generator), and wait_for_checkpoints
    leaves the manifest; a blocking save after it lands last."""
    trainer = Trainer(_s4(), ssm_lr=5e-4, device="cpu")
    state = trainer.init()
    for x, y in _batches(2):
        state, _ = trainer.train_step(state, x, y)
    at_save = {k: v.clone() for k, v in state.model.state_dict().items()}
    opt_at_save = [{k: v.clone() for k, v in s.items()}
                   for s in state.optimizer.state_dict()["state"].values()]
    gen_at_save = state.dropout_generator.get_state()
    save_checkpoint(str(tmp_path / "ck"), state, history={"lr": [1e-3]},
                    block=False)
    for x, y in _batches(2, seed=1):
        state, _ = trainer.train_step(state, x, y)
    wait_for_checkpoints()
    assert sorted(os.listdir(tmp_path / "ck")) == ["manifest.json",
                                                   "state.pt"]
    fresh = Trainer(_s4(seed=5), ssm_lr=5e-4, device="cpu")
    restored, history = restore_checkpoint(str(tmp_path / "ck"),
                                           fresh.init())
    assert restored.step == 2 and history == {"lr": [1e-3]}
    live = state.model.state_dict()
    for k, v in restored.model.state_dict().items():
        assert torch.equal(v, at_save[k]), k
    assert sum(not torch.equal(v, live[k]) for k, v in at_save.items()) > 10
    for got, want in zip(restored.optimizer.state_dict()["state"].values(),
                         opt_at_save):
        for name in want:
            assert torch.equal(got[name], want[name]), name
    assert torch.equal(restored.dropout_generator.get_state(), gen_at_save)
    # a blocking save waits for the asynchronous ones, so it lands last
    save_checkpoint(str(tmp_path / "ck2"), state, block=False)
    save_checkpoint(str(tmp_path / "ck2"), restored)
    again, _ = restore_checkpoint(str(tmp_path / "ck2"),
                                  Trainer(_s4(), device="cpu").init())
    assert again.step == 2


def test_async_save_error_surfaces_at_wait(tmp_path, monkeypatch):
    from resolution_pde_tpu_torch.train import checkpoint

    def fail(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint, "_write", fail)
    state = Trainer(_s4(), device="cpu").init()
    save_checkpoint(str(tmp_path / "ck"), state, block=False)
    with pytest.raises(OSError, match="disk full"):
        wait_for_checkpoints()
    wait_for_checkpoints()  # drained: nothing left to raise


def test_profile_step_writes_a_trace(tmp_path):
    trainer = Trainer(_s4(), device="cpu")
    state = trainer.init()
    x, y = _batches(1)[0]
    state, trace_dir = trainer.profile_step(state, x, y,
                                            str(tmp_path / "trace"),
                                            n_steps=2)
    assert trace_dir == str(tmp_path / "trace") and state.step == 3
    traces = os.listdir(trace_dir)
    assert len(traces) == 1 and traces[0].endswith(".json")
    assert os.path.getsize(os.path.join(trace_dir, traces[0])) > 0


# -- serving a checkpoint ------------------------------------------------------

@pytest.mark.parametrize("mode", ["dplr", "diag"])
def test_from_checkpoint_serves_the_trained_weights(tmp_path, mode):
    """An engine from the checkpoint predicts what the engine over the live
    model predicts: bit for bit on the same route, within 1e-4 on the
    kernels' route (their plain versions here)."""
    trainer = Trainer(_s4(mode), ssm_lr=5e-4, device="cpu")
    state = trainer.init()
    for x, y in _batches(2):
        state, _ = trainer.train_step(state, x, y)
    save_checkpoint(str(tmp_path / "ck"), state, block=False)
    wait_for_checkpoints()
    norms = dict(x_normalizer=SimpleNormalizer(0.1, 1.3),
                 y_normalizer=SimpleNormalizer(-0.2, 0.9))
    live = ServingEngine(state.model, device="cpu", **norms)
    live.warmup(spatial_shapes=[16], batch_sizes=[4], in_channels=3)
    x = _batches(1, seed=3)[0][0][:3]
    want = live.predict(x)
    for impl, check in (("jnp", np.testing.assert_array_equal),
                        ("pallas", lambda g, w: rel_l2(g, w) <= RTOL)):
        eng = ServingEngine.from_checkpoint(
            _s4(mode, kernel_impl=impl, seed=9), str(tmp_path / "ck"),
            x[:1], device="cpu", **norms)
        eng.warmup(spatial_shapes=[16], batch_sizes=[4], in_channels=3)
        got = eng.predict(x)
        assert got.shape == (3, 1, 16)
        assert check(got, want) in (None, True)


def test_cost_summary_counts_each_bucket():
    """One entry per bucket with positive flops; for a model with no hand
    kernel (the torch.fft conv and the dense FeedForward) it is
    FlopCounterMode's own count of the bucket."""
    from torch.utils.flop_counter import FlopCounterMode

    model = FFNO2D(in_channels=1, out_channels=1, width=4, n_layers=2,
                   n_modes=4, factor=2, n_ff_layers=2, layer_norm=True,
                   spectral_impl="fft", ff_impl="dense",
                   generator=torch.Generator().manual_seed(0))
    eng = ServingEngine(model, device="cpu")
    eng.warmup(spatial_shapes=[(8, 12)], batch_sizes=[2, 3],
               rollout_steps=[2])
    cost = eng.cost_summary()
    assert sorted(cost) == sorted(str(k) for k in eng.buckets())
    assert len(cost) == 4
    for key in eng.buckets():
        counter = FlopCounterMode(display=False)
        with counter, torch.no_grad():
            x = torch.zeros((key[3], key[2]) + key[1])
            if key[0] == "predict":
                eng._predict(x)
            else:
                eng._forecast(x, key[4])
        assert cost[str(key)] == {"flops": float(counter.get_total_flops())}
        assert cost[str(key)]["flops"] > 0
    s4eng = ServingEngine(_s4("dplr", kernel_impl="pallas"), device="cpu")
    s4eng.warmup(spatial_shapes=[16, 32], batch_sizes=[2], in_channels=3)
    s4cost = s4eng.cost_summary()
    assert len(s4cost) == 2 and all(v["flops"] > 0 for v in s4cost.values())
