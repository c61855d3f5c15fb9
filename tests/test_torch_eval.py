"""The port's evaluation (evaluation/) against the JAX package's on
bridged weights (utils.jax_bridge.ffno2d_state_dict): the super-resolution
sweep and the rollout of a tiny FFNO2D at resolutions {16, 32}, with the
simple and the unit_gaussian normalizer (per-location stats adapted to
each grid), with and without the resize round trip, and the spectrum sums
and their finalizers in 1D and 2D. f32 within 1e-4 relative.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from resolution_pde_tpu import evaluation as jev  # noqa: E402
from resolution_pde_tpu.evaluation import frequency as jfreq  # noqa: E402
from resolution_pde_tpu.evaluation import rollout as jroll  # noqa: E402
from resolution_pde_tpu.models import FFNO2D as JaxFFNO2D  # noqa: E402
from resolution_pde_tpu.ops import normalizers as jnorm  # noqa: E402
from resolution_pde_tpu_torch import evaluation as tev  # noqa: E402
from resolution_pde_tpu_torch.data.dataset import ArrayDataset  # noqa: E402
from resolution_pde_tpu_torch.evaluation import frequency as tfreq  # noqa: E402
from resolution_pde_tpu_torch.models import FFNO2D  # noqa: E402
from resolution_pde_tpu_torch.ops import normalizers as tnorm  # noqa: E402
from resolution_pde_tpu_torch.utils.jax_bridge import ffno2d_state_dict  # noqa: E402

CFG = dict(in_channels=1, out_channels=1, width=6, n_layers=2, n_modes=6,
           factor=2, ff_weight_norm=True, n_ff_layers=2, layer_norm=True)
RTOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    f = np.fft.rfft2(rng.standard_normal((6, 32, 32)))
    f[:, 5:-4, :] = 0
    f[:, :, 5:] = 0
    base = np.fft.irfft2(f, s=(32, 32)).astype(np.float32) * 8 + 1
    traj = np.stack([np.roll(base, i, axis=-1) for i in range(5)], axis=1)
    jmodel = JaxFFNO2D(**CFG)
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, 1, 32, 32)))
    model = FFNO2D(**CFG)
    model.load_state_dict(ffno2d_state_dict(params))
    x = traj[:, 1:-1].reshape(-1, 1, 32, 32)
    y = traj[:, 2:].reshape(-1, 1, 32, 32)
    return dict(traj=traj, x=x, y=y, jmodel=jmodel, params=params,
                model=model)


def _normalizers(kind, x, y):
    if kind is None:
        return (None,) * 4
    jcls = getattr(jnorm, kind)
    tcls = getattr(tnorm, kind)
    return jcls.fit(x), jcls.fit(y), tcls.fit(x), tcls.fit(y)


def _builder(s, res):
    f = 32 // res
    return ArrayDataset(s["x"][..., ::f, ::f], s["y"][..., ::f, ::f])


@pytest.mark.parametrize("kind,resize", [
    ("SimpleNormalizer", False), ("UnitGaussianNormalizer", False),
    ("SimpleNormalizer", True), (None, False)])
def test_superres_sweep_matches_jax(setup, kind, resize):
    s = setup
    jx, jy, tx, ty = _normalizers(kind, s["x"], s["y"])
    kw = dict(current_res=32, test_resolutions=[16, 32], batch_size=5,
              spatial_ndim=2, resize_to_train=resize,
              analyze_frequencies=True, n_plot_examples=2, strict=True)
    want = jev.evaluate_all_resolutions(
        s["jmodel"], s["params"], lambda r: _builder(s, r), x_normalizer=jx,
        y_normalizer=jy, **kw)
    got = tev.evaluate_all_resolutions(
        s["model"], lambda r: _builder(s, r), x_normalizer=tx,
        y_normalizer=ty, **kw)
    assert sorted(got["results"]) == [16, 32]
    for r in (16, 32):
        assert got["results"][r] == pytest.approx(want["results"][r],
                                                  rel=RTOL)
        for g, w in zip(got["frequency_data"][r], want["frequency_data"][r]):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-4)
        for k in ("inputs", "predictions", "targets"):
            np.testing.assert_allclose(got["plot_data"][r][k],
                                       want["plot_data"][r][k],
                                       rtol=RTOL, atol=1e-4)
        assert got["seconds"][r] >= 0
    assert s["model"].training  # the sweep restores the module's mode


@pytest.mark.parametrize("kind", ["SimpleNormalizer",
                                  "UnitGaussianNormalizer"])
def test_rollout_matches_jax(setup, kind):
    s = setup
    jx, jy, tx, ty = _normalizers(kind, s["x"], s["y"])

    def builder(res):
        return s["traj"][..., :: 32 // res, :: 32 // res]

    kw = dict(current_res=32, test_resolutions=[16, 32], rollout_steps=3,
              batch_size=4, spatial_ndim=2, strict=True)
    want_steps, got_steps, seconds = {}, {}, {}
    want = jev.evaluate_rollout_all_resolutions(
        s["jmodel"], s["params"], builder, x_normalizer=jx, y_normalizer=jy,
        per_step_out=want_steps, **kw)
    got = tev.evaluate_rollout_all_resolutions(
        s["model"], builder, x_normalizer=tx, y_normalizer=ty,
        per_step_out=got_steps, seconds_out=seconds, **kw)
    assert sorted(got) == sorted(seconds) == [16, 32]
    for r in (16, 32):
        assert got[r] == pytest.approx(want[r], rel=RTOL)
        np.testing.assert_allclose(got_steps[r], want_steps[r], rtol=RTOL)


def test_rollout_edge_cases(setup):
    s = setup
    # window_size > 1 takes the window route (ported): trajectories too
    # short to seed the window raise as JAX's do
    for fn, args in ((jroll.window_rollout_loss, (s["jmodel"], s["params"])),
                     (tev.window_rollout_loss, (s["model"],))):
        with pytest.raises(ValueError, match="cannot seed a window"):
            fn(*args, s["traj"][:, :4, 0], 3, 4)
    with pytest.raises(ValueError, match="cannot roll out"):
        tev.rollout_loss(s["model"], s["traj"][:, :1], 3, spatial_ndim=2)
    per_step = []
    with pytest.warns(UserWarning, match="empty"):
        assert np.isnan(tev.rollout_loss(s["model"], s["traj"][:0], 2,
                                         per_step_losses=per_step,
                                         spatial_ndim=2))
    assert len(per_step) == 2 and np.isnan(per_step).all()
    # a failing resolution is recorded as NaN unless strict
    out = tev.evaluate_all_resolutions(
        s["model"], lambda r: 1 / 0, current_res=32, test_resolutions=[32])
    assert np.isnan(out["results"][32])
    with pytest.raises(ZeroDivisionError):
        tev.evaluate_all_resolutions(
            s["model"], lambda r: 1 / 0, current_res=32,
            test_resolutions=[32], strict=True)
    assert tev.get_lower_resolutions(256) == [32, 64, 128, 256]


@pytest.mark.parametrize("shape", [(3, 1, 16), (2, 16), (3, 1, 12, 10)])
def test_spectrum_sums(shape):
    rng = np.random.default_rng(1)
    y = rng.standard_normal(shape).astype(np.float32)
    y_hat = y + 0.1 * rng.standard_normal(shape).astype(np.float32)
    if len(shape) == 4:
        got = tfreq.decompose_error_by_frequency_2d(
            torch.from_numpy(y_hat), torch.from_numpy(y), num_radial_bins=8)
        want = jfreq.decompose_error_by_frequency_2d(y_hat, y,
                                                     num_radial_bins=8)
    else:
        got = tfreq.decompose_error_by_frequency_1d(
            torch.from_numpy(y_hat), torch.from_numpy(y), num_modes=6)
        want = jfreq.decompose_error_by_frequency_1d(y_hat, y, num_modes=6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=1e-6)
