"""The port's training slice on the CPU: the Trainer's loss trajectory
against the JAX package's Trainer from bridged weights (FFNO2D, and S4Model
with its state-space parameters kept out of weight decay), the schedules,
the gradient clip, accumulation, the normalizer decode, checkpoints with
exact resume, the manifest guard and remat.

Tolerances: the 5-step trajectory in f32 at 1e-4 relative per step (the
two optimizers round differently); schedules exactly (the same float
arithmetic); resume and remat bit for bit (the same CPU ops in the same
order).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from resolution_pde_tpu.models import FFNO2D as JaxFFNO2D  # noqa: E402
from resolution_pde_tpu.models.s4 import S4Model as JaxS4Model  # noqa: E402
from resolution_pde_tpu.ops.normalizers import (  # noqa: E402
    SimpleNormalizer as JaxNorm)
from resolution_pde_tpu.parallel.mesh import make_mesh  # noqa: E402
from resolution_pde_tpu.train import schedules as jsched  # noqa: E402
from resolution_pde_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from resolution_pde_tpu_torch.models import FFNO2D  # noqa: E402
from resolution_pde_tpu_torch.models.s4 import (  # noqa: E402
    SSM_PARAM_NAMES, S4Model)
from resolution_pde_tpu_torch.ops.losses import relative_l2  # noqa: E402
from resolution_pde_tpu_torch.ops.normalizers import SimpleNormalizer  # noqa: E402
from resolution_pde_tpu_torch.train import (  # noqa: E402
    ReduceLROnPlateau, Trainer, constant_lr, cosine_annealing_lr,
    get_schedule, restore_checkpoint, save_checkpoint, step_lr)
from resolution_pde_tpu_torch.utils.jax_bridge import (  # noqa: E402
    ffno2d_state_dict, s4_model_state_dict)

CFG = dict(in_channels=1, out_channels=1, width=6, n_layers=2, n_modes=6,
           factor=2, ff_weight_norm=True, n_ff_layers=3, layer_norm=True)
GRID = (12, 16)
SLICE = dict(spectral_impl="pallas2", ff_impl="fused", dropout=0.0)


def _data(seed=0, batch=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, 1) + GRID).astype(np.float32)
    return x, np.roll(x, 3, axis=-1)


def _model(seed=0, **kw):
    return FFNO2D(**CFG, **{**SLICE, **kw},
                  generator=torch.Generator().manual_seed(seed))


def test_loss_trajectory_matches_jax_trainer():
    """5 AdamW steps from the same weights on the same batch, with the
    y-normalizer decoded before the loss, on the slice's path (pallas2 +
    fused, f32): the per-step losses agree to 1e-4 relative."""
    x, y = _data()
    stats = (-0.2, 0.9)
    jmodel = JaxFFNO2D(**CFG, **SLICE)
    jtrainer = JaxTrainer(jmodel, learning_rate=1e-3, use_normalizer=True,
                          y_normalizer=JaxNorm(*stats),
                          mesh=make_mesh(devices=jax.devices()[:1]))
    jstate = jtrainer.init(x[:1])
    trainer = Trainer(FFNO2D(**CFG, **SLICE), learning_rate=1e-3,
                      use_normalizer=True,
                      y_normalizer=SimpleNormalizer(*stats), device="cpu")
    trainer.model.load_state_dict(ffno2d_state_dict(jstate.params))
    state = trainer.init()
    want, got = [], []
    for _ in range(5):
        jstate, jl = jtrainer._train_step(jstate, jnp.asarray(x),
                                          jnp.asarray(y), jtrainer.y_normalizer)
        want.append(float(jl))
        state, loss = trainer.train_step(state, x, y)
        got.append(float(loss))
    assert state.step == 5
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


def test_grad_clip_is_optax_clip_by_global_norm():
    rng = np.random.default_rng(1)
    shapes = [(3, 4), (5,), (2, 2, 2)]
    trainer = Trainer(_model(), grad_clip=0.5, device="cpu")
    for scale in (0.01, 10.0):  # below the clip: unchanged; above: scaled
        grads = [(rng.standard_normal(s) * scale).astype(np.float32)
                 for s in shapes]
        want, _ = optax.clip_by_global_norm(0.5).update(
            [jnp.asarray(g) for g in grads], None)
        params = [torch.nn.Parameter(torch.zeros(s)) for s in shapes]
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g.copy())
        trainer._clip_grads(params)
        for p, w in zip(params, want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w),
                                       rtol=1e-6, atol=1e-7)


def test_schedules_match_jax():
    for ours, theirs in [
            (cosine_annealing_lr(1e-3, 10, 1e-5),
             jsched.cosine_annealing_lr(1e-3, 10, 1e-5)),
            (step_lr(1e-3, 3, 0.5), jsched.step_lr(1e-3, 3, 0.5)),
            (constant_lr(2e-3), jsched.constant_lr(2e-3)),
            (get_schedule("StepLR", 1e-3, 10, step_size=2),
             jsched.get_schedule("StepLR", 1e-3, 10, step_size=2)),
            (get_schedule("cosine", 1e-3, 10),
             jsched.get_schedule("cosine", 1e-3, 10))]:
        assert [ours(e) for e in range(12)] == [theirs(e) for e in range(12)]
    with pytest.raises(ValueError, match="unknown schedule"):
        get_schedule("bogus", 1e-3, 10)


def test_plateau_matches_jax_and_round_trips():
    metrics = [1.0, 0.9, 0.95, 0.95, 0.95, 0.89, 0.9, 0.9, 0.9, 0.9]
    ours = ReduceLROnPlateau(1e-3, factor=0.5, patience=1, min_lr=1e-4)
    theirs = jsched.ReduceLROnPlateau(1e-3, factor=0.5, patience=1,
                                      min_lr=1e-4)
    half = None
    for i, m in enumerate(metrics):
        assert ours.step(m) == theirs.step(m)
        if i == 4:
            half = ours.state_dict()
    assert ours.lr < 1e-3
    resumed = ReduceLROnPlateau(1e-3, factor=0.5, patience=1, min_lr=1e-4)
    resumed.load_state_dict(half)
    for m in metrics[5:]:
        resumed.step(m)
    assert resumed.state_dict() == ours.state_dict()


def _one_step(accum, x, y, weights=None):
    trainer = Trainer(_model(), accum_steps=accum, device="cpu")
    state = trainer.init()
    state, loss = trainer.train_step(state, x, y, weights)
    return float(loss), [p.detach().clone() for p in state.model.parameters()]


def test_accumulation_pads_and_weighs_real_rows():
    """accum_steps=2 on a batch of 5 (padded to 6 with a zero-weight row)
    reproduces accum_steps=1: the same loss and the same update; and
    weights zero a row out of the mean."""
    x, y = _data(seed=2, batch=5)
    l1, p1 = _one_step(1, x, y)
    l2, p2 = _one_step(2, x, y)
    assert l2 == pytest.approx(l1, rel=1e-6)
    for a, b in zip(p1, p2):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    w = np.array([1, 1, 1, 1, 0], np.float32)
    lw, _ = _one_step(2, x, y, w)
    l4, _ = _one_step(1, x[:4], y[:4])
    assert lw == pytest.approx(l4, rel=1e-6)


def test_normalizer_decode_before_loss():
    x, y = _data(seed=3)
    norm = SimpleNormalizer(0.5, 2.0)
    trainer = Trainer(_model(), use_normalizer=True, y_normalizer=norm,
                      device="cpu")
    state = trainer.init()
    with torch.no_grad():
        pred = state.model.eval()(torch.from_numpy(x))
    want = relative_l2(norm.decode(pred), norm.decode(torch.from_numpy(y)))
    got = trainer.eval_step(state, x, y)
    torch.testing.assert_close(got, want)
    plain = trainer.eval_step(state, x, y, y_normalizer=None)
    assert float(plain) != pytest.approx(float(got), rel=1e-3)


def _run(trainer, state, batches):
    losses = []
    for x, y in batches:
        state, loss = trainer.train_step(state, x, y)
        losses.append(float(loss))
    return losses


def test_checkpoint_resume_is_exact(tmp_path):
    """Save after 2 of 4 steps, restore into fresh objects, run the last 2:
    the losses, parameters and optimizer moments equal the uninterrupted
    run's, bit for bit, with dropout drawing from the saved generator."""
    kw = dict(ff_impl="dense", dropout=0.1)
    batches = [_data(seed=s) for s in range(4)]
    trainer = Trainer(_model(**kw), seed=7, device="cpu")
    state = trainer.init()
    full = _run(trainer, state, batches)

    trainer = Trainer(_model(**kw), seed=7, device="cpu")
    state = trainer.init()
    first = _run(trainer, state, batches[:2])
    save_checkpoint(str(tmp_path / "ck"), state,
                    history={"train_loss": first, "val_loss": []},
                    extra={"plateau": {"lr": 1e-3, "best": 0.5,
                                       "num_bad": 1}})

    trainer2 = Trainer(_model(seed=1, **kw), seed=99, device="cpu")
    state2 = trainer2.init()
    state2, history, extra = restore_checkpoint(str(tmp_path / "ck"), state2,
                                                with_extra=True)
    assert state2.step == 2
    assert history == {"train_loss": first}
    assert extra["plateau"]["num_bad"] == 1
    rest = _run(trainer2, state2, batches[2:])
    assert first + rest == full
    trainer = Trainer(_model(**kw), seed=7, device="cpu")
    state = trainer.init()
    _run(trainer, state, batches)
    for a, b in zip(state.model.parameters(), state2.model.parameters()):
        assert torch.equal(a, b)
    sa, sb = state.optimizer.state_dict(), state2.optimizer.state_dict()
    for k in sa["state"]:
        for name in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(sa["state"][k][name], sb["state"][k][name])


def test_checkpoint_manifest_guard(tmp_path):
    trainer = Trainer(_model(), device="cpu")
    save_checkpoint(str(tmp_path / "ck"), trainer.init())
    other = Trainer(FFNO2D(**dict(CFG, width=4), **SLICE), device="cpu")
    with pytest.raises(ValueError, match="param structure does not match"):
        restore_checkpoint(str(tmp_path / "ck"), other.init())


@pytest.mark.parametrize("kw", [dict(), dict(ff_impl="dense", dropout=0.1)])
def test_remat_equals_no_remat(kw):
    """Activation checkpointing changes nothing: the same loss and the same
    gradients, bit for bit, dropout masks included."""
    x, y = _data(seed=4)
    grads = []
    for remat in (False, True):
        trainer = Trainer(_model(remat=remat, **kw), device="cpu")
        state = trainer.init()
        state.model.train()
        loss = relative_l2(state.model(torch.from_numpy(x)),
                           torch.from_numpy(y))
        loss.backward()
        grads.append((loss.detach(), [p.grad for p in
                                      state.model.parameters()]))
    (l0, g0), (l1, g1) = grads
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_fit_steps_schedules_and_calls_back():
    batches = [_data(seed=s, batch=2) for s in range(3)]
    trainer = Trainer(_model(), learning_rate=1e-3, device="cpu")
    state = trainer.init()
    seen = []
    state, hist = trainer.fit(
        state, lambda: iter(batches), val_loader_fn=batches[:1], epochs=3,
        schedule=step_lr(1e-3, 1, 0.5),
        epoch_callback=lambda e, s, h: seen.append((e, s.step,
                                                    len(h.train_loss))))
    assert seen == [(0, 3, 1), (1, 6, 2), (2, 9, 3)]
    assert hist.lr == [5e-4, 2.5e-4, 1.25e-4]
    assert all(np.isfinite(hist.train_loss)) and all(np.isfinite(hist.val_loss))
    assert set(dataclasses.asdict(hist)) == {"train_loss", "val_loss", "lr",
                                             "epoch_time_s"}
    # threshold 1: no epoch counts as better, so every epoch cuts the lr
    plateau = ReduceLROnPlateau(1e-3, factor=0.1, patience=0, threshold=1.0)
    state, hist = trainer.fit(state, batches, val_loader_fn=batches[:1],
                              epochs=2, schedule=plateau)
    assert hist.lr == pytest.approx([1e-4, 1e-5])


def test_dropout_draws_from_the_seeded_generator():
    x, y = _data(seed=5)
    kw = dict(ff_impl="dense", dropout=0.2)
    runs = []
    for seed in (3, 3, 4):
        trainer = Trainer(_model(**kw), seed=seed, device="cpu")
        state = trainer.init()
        runs.append(_run(trainer, state, [(x, y)] * 2))
    assert runs[0] == runs[1] and runs[0] != runs[2]


def test_trainer_refuses_what_is_not_ported():
    """accum_steps below 1 raises. ssm_lr is ported: on a model without
    state-space parameters it changes nothing, as JAX's scale masked to no
    leaf (one group, the same steps bit for bit)."""
    with pytest.raises(ValueError, match="accum_steps"):
        Trainer(_model(), accum_steps=0, device="cpu")
    batches = [_data(seed=s, batch=2) for s in range(2)]
    runs = []
    for ssm_lr in (None, 1e-4):
        trainer = Trainer(_model(), ssm_lr=ssm_lr, device="cpu")
        state = trainer.init()
        assert len(state.optimizer.param_groups) == 1
        trainer.set_lr(state, 5e-4)
        assert trainer.current_lr(state) == 5e-4
        runs.append(_run(trainer, state, batches))
    assert runs[0] == runs[1]


@pytest.mark.parametrize("mode", ["diag", "dplr"])
def test_no_weight_decay_on_ssm_parameters(mode):
    """As tests/test_s4.py:211 for the JAX Trainer: with zero gradients and
    weight_decay 0.1, one AdamW step leaves every S4 state-space parameter
    bit for bit and moves every nonzero other parameter (decay alone)."""
    model = S4Model(d_input=1, d_output=1, d_model=8, n_layers=1,
                    dropout=0.0, mode=mode, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, learning_rate=1e-2, weight_decay=0.1,
                      device="cpu")
    state = trainer.init()
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    state.optimizer.step()
    n_ssm = n_decayed = 0
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[-1] in SSM_PARAM_NAMES:
            assert torch.equal(p, before[name]), name
            n_ssm += 1
        elif bool(before[name].abs().max() > 0):
            assert not torch.equal(p, before[name]), name
            n_decayed += 1
    assert n_ssm >= 2 and n_decayed > 0
    assert [g["weight_decay"] for g in state.optimizer.param_groups] == [
        0.1, 0.0]
    trainer.set_lr(state, 3e-3)
    assert trainer.current_lr(state) == 3e-3
    assert all(g["lr"] == 3e-3 for g in state.optimizer.param_groups)


def test_ffno_optimizer_keeps_one_group():
    trainer = Trainer(_model(), device="cpu")
    groups = trainer.init().optimizer.param_groups
    assert len(groups) == 1 and groups[0]["weight_decay"] == 1e-4


@pytest.mark.parametrize("mode", ["diag", "dplr"])
def test_s4_loss_trajectory_matches_jax_trainer(mode):
    """3 AdamW steps of S4Model (jnp route) from weights bridged from the
    JAX Trainer's init, with lr 1e-2 and weight_decay 0.1 so that decaying
    the state-space parameters would show: the per-step losses agree to
    1e-4 relative (f32; the two optimizers and FFTs round differently)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 2, 32)).astype(np.float32)
    y = np.roll(x[:, :1], 2, axis=-1)
    kw = dict(d_input=2, d_output=1, d_model=8, n_layers=1, dropout=0.0,
              mode=mode)
    jtrainer = JaxTrainer(JaxS4Model(**kw), learning_rate=1e-2,
                          weight_decay=0.1,
                          mesh=make_mesh(devices=jax.devices()[:1]))
    jstate = jtrainer.init(x[:1])
    model = S4Model(**kw, kernel_impl="jnp", device="cpu")
    model.load_state_dict(s4_model_state_dict(jstate.params))
    trainer = Trainer(model, learning_rate=1e-2, weight_decay=0.1,
                      device="cpu")
    state = trainer.init()
    want, got = [], []
    for _ in range(3):
        jstate, jl = jtrainer._train_step(jstate, jnp.asarray(x),
                                          jnp.asarray(y), None)
        want.append(float(jl))
        state, loss = trainer.train_step(state, x, y)
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
