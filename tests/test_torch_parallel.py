"""The port's parallel package (resolution_pde_tpu_torch/parallel) against
the JAX package's on the CPU, over gloo.

One module-scoped group of 4 ranks (tests/torch_parallel_worker.py, each
rank a process of its own joined through a file store under tmp_path, on
one thread) runs every case once; each test below reads its case. The
references are computed here: JAX's Trainer on the same mesh shape over
the tests' virtual devices, and the port's single-process Trainer, both
from the same weights (JAX's initial params through utils.jax_bridge).

Tolerances: against JAX's run on the same mesh, 1e-4 relative (losses
and every parameter); against the port's single process, JAX's own for
its sharded trainers (tests/test_fsdp.py): losses and parameters 2e-5 /
2e-6; the straggler and BatchNorm cases
JAX's tests/test_spatial_sharding.py's (loss 1e-5, parameters 1e-4 /
1e-6, running statistics 1e-5 / 1e-6); BatchNorm's train-mode output and
statistics against JAX's float64 forward at tests/test_torch_cno.py's
1e-4 and 1e-5. The "spatial" axis (grid rows sharded): FFNO2D on each
route and FNO2d against JAX's unsharded forward at 1e-4 / 1e-5 and
jax.grad at 1e-3 / 1e-5 (JAX's tests/test_spatial_sharding.py), against
the port's single process at 1e-5 (relative L2 of each gradient); its
train steps and the multislice ones against JAX on the same mesh at
1e-4. The sharded serving engine against one engine and the pipeline's
gradients against JAX's at 1e-6 and 1e-5. A second group of 2 ranks runs
main_2d against JAX's main_2d on its 8 virtual devices, the same global
batch of 8.
"""

import contextlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from jax.sharding import NamedSharding, PartitionSpec  # noqa: E402

from resolution_pde_tpu.models import FFNO2D as JaxFFNO2D  # noqa: E402
from resolution_pde_tpu.models import FNO1d as JaxFNO1d  # noqa: E402
from resolution_pde_tpu.models import FNO2d as JaxFNO2d  # noqa: E402
from resolution_pde_tpu.models.cno import CNO2d as JaxCNO2d  # noqa: E402
from resolution_pde_tpu.models.mgpt import MoEGPTNO as JaxMoEGPTNO  # noqa: E402
from resolution_pde_tpu.ops.losses import (  # noqa: E402
    relative_l2 as jax_relative_l2)
from resolution_pde_tpu.parallel import (  # noqa: E402
    ffno_tp_specs as jax_tp_specs, fsdp_specs as jax_fsdp_specs,
    make_mesh as jax_make_mesh, merge_specs as jax_merge_specs,
    moe_ep_specs as jax_ep_specs, shard_batch as jax_shard_batch,
    shard_train_state as jax_shard_train_state, specs_to_shardings)
from resolution_pde_tpu.parallel.mesh import (  # noqa: E402
    batch_sharding as jax_batch_sharding,
    make_multislice_mesh as jax_make_multislice_mesh)
from resolution_pde_tpu.parallel.pipeline import (  # noqa: E402
    pipeline_apply as jax_pipeline_apply)
from resolution_pde_tpu.train import Trainer as JaxTrainer  # noqa: E402
from resolution_pde_tpu_torch.models.cno import CNO2d  # noqa: E402
from resolution_pde_tpu_torch.models.ffno import FFNO1D, FFNO2D  # noqa: E402
from resolution_pde_tpu_torch.models.fno import FNO1d, FNO2d  # noqa: E402
from resolution_pde_tpu_torch.ops.grids import concat_grid_2d  # noqa: E402
from resolution_pde_tpu_torch.ops.losses import relative_l2  # noqa: E402
from resolution_pde_tpu_torch.ops.normalizers import (  # noqa: E402
    UnitGaussianNormalizer)
from resolution_pde_tpu_torch.parallel import (  # noqa: E402
    make_mesh, make_multislice_mesh, shard_batch, spatial)
from resolution_pde_tpu_torch.train import Trainer  # noqa: E402
from resolution_pde_tpu_torch.utils import jax_bridge  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_parallel_worker as W  # noqa: E402

WORLD = 4
CASES = ["mesh", "shard_batch", "straggler", "accum", "dp", "bn", "fsdp",
         "tp", "tp_fsdp", "clip", "fused_conflict", "ep", "pp", "spatial",
         "spatial_train", "multislice", "serve"]
CLIP = 0.05


def _spawn(tmp, job, world):
    """Run the worker on ``world`` ranks; their outputs, rank by rank."""
    os.makedirs(tmp, exist_ok=True)
    torch.save(job, os.path.join(tmp, "job.pt"))
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               GLOO_SOCKET_IFNAME=os.environ.get("GLOO_SOCKET_IFNAME", "lo"))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_parallel_worker.py"),
         str(tmp), str(r), str(world)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    logs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
            for r in range(world)]


def _jax_ffno(kw, x, seed):
    model = JaxFFNO2D(**{k: v for k, v in kw.items()})
    params = jax.jit(model.init)(jax.random.key(seed), jnp.asarray(x[:2]))
    return model, jax.device_get(params["params"])


def _sd(params):
    return {k: v.clone() for k, v in
            jax_bridge.ffno2d_state_dict(params).items()}


def _single(cls, kw, sd, x, y, steps, **trainer_kw):
    """The port's single-process losses and parameters."""
    model = cls(**kw)
    model.load_state_dict(sd)
    tr = Trainer(model, learning_rate=1e-3, device="cpu", **trainer_kw)
    state = tr.init()
    losses = []
    for _ in range(steps):
        state, loss = tr.train_step(state, x, y)
        losses.append(float(loss))
    return losses, {k: v.detach().clone() for k, v in
                    state.model.state_dict().items()}


def _jax_steps(model, params, x, y, mesh, specs=None, steps=3,
               grad_clip=None, place=None, bridge=None):
    """JAX's Trainer from ``params`` on ``mesh``: its losses and
    parameters (as the port's state_dict, through ``bridge``). place:
    x -> the sharded array (default: JAX's shard_batch)."""
    # fresh arrays: the train step donates its state
    params = jax.tree_util.tree_map(jnp.asarray, params)
    tr = JaxTrainer(model, learning_rate=1e-3, mesh=mesh,
                    grad_clip=grad_clip)
    state = tr.init(x[:2]).replace(params=params)
    state = state.replace(opt_state=tr.optimizer.init(params))
    if specs is not None:
        tr = JaxTrainer(model, learning_rate=1e-3, mesh=mesh,
                        grad_clip=grad_clip,
                        param_specs=specs(params, mesh))
        state = jax_shard_train_state(state, mesh, specs(params, mesh),
                                      tr.optimizer)
    losses = []
    for _ in range(steps):
        if place is None:
            (xs, ys), w = jax_shard_batch((jnp.asarray(x), jnp.asarray(y)),
                                          mesh)
        else:
            xs, ys, w = place(x), place(y), None
        state, loss = tr._train_step(state, xs, ys, None, w)
        losses.append(float(loss))
    params = jax.device_get(state.params)
    return losses, (_sd(params) if bridge is None else bridge(params))


def _fsdp(params, mesh):
    """JAX's FSDP layout at the workers' min_size."""
    return jax_fsdp_specs(params, mesh, min_size=1024)


def _tp_fsdp(params, mesh):
    return jax_merge_specs(jax_tp_specs(params, mesh), _fsdp(params, mesh))


def _held_to_jax(out, want_losses, want):
    """A rank's losses and parameters against JAX's run, 1e-4 relative."""
    np.testing.assert_allclose(out["losses"], want_losses, rtol=1e-4)
    assert sorted(out["params"]) == sorted(want)
    for k in want:
        assert _rel(out["params"][k], want[k]) < 1e-4, k


@contextlib.contextmanager
def _one_thread():
    """The ranks' thread count: a conv bias in front of a BatchNorm has no
    gradient in exact arithmetic, so its Adam step is the sign of the
    roundoff, which follows the reduction order of the threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _close(got: dict, want: dict, rtol, atol):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=rtol, atol=atol, err_msg=k)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    x2 = rng.standard_normal((8, 1, 16, 16)).astype(np.float32)
    y2 = np.roll(x2, 2, axis=-1)
    x1 = rng.standard_normal((5, 1, 32)).astype(np.float32)
    y1 = np.roll(x1, 3, axis=-1)
    xc = rng.standard_normal((8, 1, 32, 32)).astype(np.float32)
    yc = np.roll(xc, 2, axis=-1)
    jm, jp = _jax_ffno(W.FFNO2D_SMALL, x2, 0)
    jm_f, jp_f = _jax_ffno(W.FFNO2D_FSDP, x2, 1)
    jcno = JaxCNO2d(1, 1, 32, **W.CNO_SMALL)
    vcno = jax.device_get(jax.jit(jcno.init)(jax.random.key(2),
                                             jnp.asarray(xc[:2])))
    jmg = JaxMoEGPTNO(**W.MGPT_SMALL)
    g = rng.standard_normal((4, 12, 2)).astype(np.float32)
    u = rng.standard_normal((4, 10, 2)).astype(np.float32)
    pos = rng.standard_normal((4, 12, 2)).astype(np.float32)
    pmg = jax.device_get(jax.jit(jmg.init)(jax.random.key(3), g, u,
                                           pos))["params"]
    gen = torch.Generator().manual_seed(4)
    per_stage = [{"w": 0.1 * torch.randn(16, 16, generator=gen),
                  "b": 0.1 * torch.randn(16, generator=gen)}
                 for _ in range(4)]
    ffno1d = FFNO1D(**W.FFNO1D_SMALL,
                    generator=torch.Generator().manual_seed(5))
    x_pp = torch.randn(8, 16, generator=gen)
    r_pp = torch.randn(8, 16, generator=gen)
    # the "spatial" axis: JAX's tests/test_spatial_sharding.py models
    xs = rng.standard_normal((4, 1, 16, 16)).astype(np.float32)
    ys = np.roll(xs, 2, axis=-1)
    jsp, psp = _jax_ffno(W.SPATIAL_FFNO, xs, 6)
    jfno = JaxFNO2d(**W.FNO2D_SMALL)
    pfno = jax.device_get(jax.jit(jfno.init)(jax.random.key(7),
                                             jnp.asarray(xs[:2])))["params"]
    x_f1 = rng.standard_normal((8, 1, 32)).astype(np.float32)
    y_f1 = np.roll(x_f1, 4, axis=-1)
    jf1 = JaxFNO1d(**W.FNO1D_SMALL)
    pf1 = jax.device_get(jax.jit(jf1.init)(jax.random.key(8),
                                           jnp.asarray(x_f1[:2])))["params"]
    xq = rng.standard_normal((8, 1, 16, 16)).astype(np.float32)
    return {
        "cases": CASES,
        "clip": CLIP,
        "straggler": (x1, y1, ffno1d.state_dict()),
        "ffno2d": (x2, y2, _sd(jp)),
        "ffno2d_fsdp": (x2, y2, _sd(jp_f)),
        "cno2d": (xc, yc, jax_bridge.cno2d_state_dict(vcno, n_res=1)),
        "mgpt": ((g, u, pos), jax_bridge.mgpt_state_dict(pmg)),
        "pp": (per_stage, x_pp, r_pp),
        "spatial": (xs, ys, {"ffno2d": _sd(psp),
                             "fno2d": jax_bridge.fno2d_state_dict(pfno)}),
        "fno1d": (x_f1, y_f1, jax_bridge.fno1d_state_dict(pf1)),
        "serve": (xq, _sd(jp)),
        "jax": {"ffno2d": (jm, jp), "ffno2d_fsdp": (jm_f, jp_f),
                "cno2d": (jcno, vcno), "mgpt": (jmg, pmg),
                "spatial_ffno2d": (jsp, psp), "fno2d": (jfno, pfno),
                "fno1d": (jf1, pf1)},
    }


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    job = {k: v for k, v in inputs.items() if k != "jax"}
    return _spawn(tmp_path_factory.mktemp("parallel"), job, WORLD)


def _case(ranks, name, rank=0):
    out = ranks[rank][name]
    assert not isinstance(out, str), out
    return out


def test_make_mesh_rules(ranks):
    out = _case(ranks, "mesh")
    assert out["default"] == {"data": WORLD}
    assert out["inferred"] == {"data": 2, "model": 2}
    assert "at most one axis may be -1" in out["two_unknown"]
    assert "!= 4 ranks" in out["wrong_size"]
    assert "not divisible by 3" in out["indivisible"]


def test_make_mesh_needs_a_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh()


def test_shard_batch_pads_weights_and_replicates(ranks):
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    pad = np.concatenate([x, np.repeat(x[:1], 3, axis=0)])
    for r in range(WORLD):
        out = _case(ranks, "shard_batch", r)
        np.testing.assert_array_equal(out["pad_rows"], pad[2 * r:2 * r + 2])
        np.testing.assert_array_equal(out["pad_weights"],
                                      [1, 1, 1, 1, 1, 0, 0, 0])
        np.testing.assert_array_equal(
            out["even_rows"].numpy(),
            np.arange(16.0).reshape(8, 2)[2 * r:2 * r + 2])
        assert out["even_weights"] is None
        np.testing.assert_array_equal(out["replicate_rows"], x)
        assert out["replicate_weights"] is None
        assert "straggler must be" in out["bad_mode"]


def test_straggler_batch_matches_one_process(ranks, inputs):
    """5 samples over 4 ranks: padded to 8, the pad rows weigh nothing."""
    x, y, sd = inputs["straggler"]
    losses, params = _single(FFNO1D, W.FFNO1D_SMALL, sd, x, y, 1)
    out = _case(ranks, "straggler")
    np.testing.assert_allclose(out["losses"], losses, rtol=1e-5)
    _close(out["params"], params, 1e-4, 1e-6)


def test_accumulation_over_ranks_matches_one_process(ranks, inputs):
    """accum_steps=2 on the straggler batch: the same weighted mean."""
    x, y, sd = inputs["straggler"]
    losses, params = _single(FFNO1D, W.FFNO1D_SMALL, sd, x, y, 1)
    out = _case(ranks, "accum")
    np.testing.assert_allclose(out["losses"], losses, rtol=1e-5)
    _close(out["params"], params, 1e-4, 1e-6)


def test_gradient_clip_takes_the_global_norm(ranks, inputs):
    """grad_clip over FSDP and tensor-parallel shards clips by the norm of
    the whole gradient, as JAX's Trainer(grad_clip=) on the same mesh and
    one process do: the sharded gradient's global norm equals one
    process's gradient norm, and after a clipped step the gradients'
    global norm is CLIP (the clip binds)."""
    x, y, sd = inputs["ffno2d_fsdp"]
    jm, jp = inputs["jax"]["ffno2d_fsdp"]
    mesh = jax_make_mesh({"data": 2, "model": 2},
                         devices=jax.devices()[:WORLD])
    want_losses, want = _jax_steps(jm, jp, x, y, mesh, specs=_tp_fsdp,
                                   steps=2, grad_clip=CLIP)
    one_losses, one = _single(FFNO2D, W.FFNO2D_FSDP, sd, x, y, 2,
                              grad_clip=CLIP)
    model = FFNO2D(**W.FFNO2D_FSDP)
    model.load_state_dict(sd)
    tr = Trainer(model, learning_rate=1e-3, device="cpu")
    tr.train_step(tr.init(), x, y)
    norm = float(torch.sqrt(sum((p.grad ** 2).sum()
                                for p in model.parameters())))
    assert norm > 2 * CLIP
    for r in range(WORLD):
        out = _case(ranks, "clip", r)
        assert out["norm"] == pytest.approx(norm, rel=1e-5)
        assert out["clipped_norm"] == pytest.approx(CLIP, rel=1e-5)
        _held_to_jax(out, want_losses, want)
        np.testing.assert_allclose(out["losses"], one_losses, rtol=2e-5,
                                   atol=2e-6)
        _close(out["params"], one, 2e-5, 2e-6)


def test_data_parallel_matches_jax_and_one_process(ranks, inputs):
    x, y, sd = inputs["ffno2d"]
    jm, jp = inputs["jax"]["ffno2d"]
    mesh = jax_make_mesh({"data": WORLD}, devices=jax.devices()[:WORLD])
    want_losses, want = _jax_steps(jm, jp, x, y, mesh)
    one_losses, one = _single(FFNO2D, W.FFNO2D_SMALL, sd, x, y, 3)
    for r in range(WORLD):
        out = _case(ranks, "dp", r)
        assert out["mesh"] == {"data": WORLD}  # the default mesh
        _held_to_jax(out, want_losses, want)
        np.testing.assert_allclose(out["losses"], one_losses, rtol=2e-5,
                                   atol=2e-6)
        _close(out["params"], one, 2e-5, 2e-6)


def test_sharded_evaluate_is_the_global_batch_mean(ranks, inputs):
    """evaluate over [8 rows, 5 rows]: the 5-row batch padded, the mean
    of the two batch means."""
    x, y, sd = inputs["ffno2d"]
    one_losses, one = _single(FFNO2D, W.FFNO2D_SMALL, sd, x, y, 3)
    model = FFNO2D(**W.FFNO2D_SMALL)
    model.load_state_dict(one)
    tr = Trainer(model, device="cpu")
    want = tr.evaluate(tr.init(), [(x, y), (x[:5], y[:5])])
    for r in range(WORLD):
        assert _case(ranks, "dp", r)["eval"] == pytest.approx(want,
                                                              rel=2e-5)


def test_batch_norm_takes_the_global_statistics(ranks, inputs):
    """Each rank's BatchNorm normalises its 2 rows with the 8-row batch's
    statistics: the train-mode output and running statistics against
    JAX's float64 forward on the whole batch."""
    x, _, _ = inputs["cno2d"]
    jmodel, v = inputs["jax"]["cno2d"]
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)
        want_y, upd = jax.jit(lambda v_, x_: jmodel.apply(
            v_, x_, deterministic=False, mutable=["batch_stats"]))(
                v64, jnp.asarray(x, jnp.float64))
        want_y = np.asarray(want_y)
        upd = jax.tree_util.tree_map(np.asarray, upd)
    stats = {k: t for k, t in jax_bridge.cno2d_state_dict(
        {"params": v["params"], **upd}, n_res=1).items() if "running" in k}
    for r in range(WORLD):
        out = _case(ranks, "bn", r)
        assert _rel(out["train_out"], want_y) < 1e-4
        assert sorted(out["stats"]) == sorted(stats)
        for k, t in stats.items():
            got, ref = np.asarray(out["stats"][k]), np.asarray(t)
            assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5, k


def test_batch_norm_straggler_replicates(ranks, inputs):
    """5 rows over 4 ranks with BatchNorm: every rank takes the batch
    whole, so one epoch matches one process, the running statistics
    included (JAX's test_bn_model_straggler_replicates_for_exact_stats)."""
    x, y, sd = inputs["cno2d"]
    model = CNO2d(1, 1, 32, **W.CNO_SMALL)
    model.load_state_dict(sd)
    tr = Trainer(model, learning_rate=1e-3, device="cpu")
    with _one_thread():
        state, loss = tr.train_epoch(tr.init(), [(x[:5], y[:5])])
    want = state.model.state_dict()
    out = _case(ranks, "bn")
    assert out["straggler_loss"] == pytest.approx(loss, rel=1e-5)
    for k, t in want.items():
        tol = (1e-5, 1e-6) if "running" in k else (1e-4, 1e-6)
        np.testing.assert_allclose(out["straggler_state"][k].numpy(),
                                   t.numpy(), rtol=tol[0], atol=tol[1],
                                   err_msg=k)


def test_fsdp_shards_and_matches_one_process(ranks, inputs):
    """FSDP on data=4 against JAX's fsdp_specs run on the same mesh and
    against one process; a layer's weight is whole only while the layer
    runs (ZeRO-3: the next layer sees the shard again)."""
    x, y, sd = inputs["ffno2d_fsdp"]
    jm, jp = inputs["jax"]["ffno2d_fsdp"]
    mesh = jax_make_mesh({"data": WORLD}, devices=jax.devices()[:WORLD])
    want_losses, want = _jax_steps(jm, jp, x, y, mesh, specs=_fsdp)
    one_losses, one = _single(FFNO2D, W.FFNO2D_FSDP, sd, x, y, 3)
    full = {k: tuple(v.shape) for k, v in one.items()}
    for r in range(WORLD):
        out = _case(ranks, "fsdp", r)
        sharded = [k for k, s in out["specs"].items() if any(s)]
        assert len(sharded) >= 4 and sorted(sharded) == out["plan"]
        for k in sharded:
            assert 4 * np.prod(out["local"][k]) == np.prod(full[k]), k
        for k in set(out["local"]) - set(sharded):
            assert out["local"][k] == full[k], k
        w = "fourier_layers.0.fourier_weight.0"
        assert out["seen"]["inside"] == ("Parameter", full[w])
        assert out["seen"]["after"] == ("DTensor", out["local"][w])
        _held_to_jax(out, want_losses, want)
        np.testing.assert_allclose(out["losses"], one_losses, rtol=2e-5,
                                   atol=2e-6)
        _close(out["params"], one, 2e-5, 2e-6)
        # the checkpoint holds the whole state; a restore slices it again
        assert out["resumed_loss"] == out["continued_loss"]


def test_tensor_parallel_matches_jax(ranks, inputs):
    x, y, sd = inputs["ffno2d"]
    jm, jp = inputs["jax"]["ffno2d"]
    mesh = jax_make_mesh({"data": 2, "model": 2},
                         devices=jax.devices()[:WORLD])
    want_losses, want = _jax_steps(jm, jp, x, y, mesh, specs=jax_tp_specs)
    one_losses, one = _single(FFNO2D, W.FFNO2D_SMALL, sd, x, y, 3)
    for r in range(WORLD):
        out = _case(ranks, "tp", r)
        for i in range(2):
            ff = f"fourier_layers.{i}.backcast_ff.layers"
            assert out["specs"][f"{ff}.0.0.weight"] == ("model", None)
            assert out["specs"][f"{ff}.0.0.bias"] == ("model",)
            assert out["specs"][f"{ff}.1.0.weight"] == (None, "model")
            assert out["local"][f"{ff}.0.0.weight"] == (16, 8)
            assert out["local"][f"{ff}.0.0.bias"] == (16,)
            assert out["local"][f"{ff}.1.0.weight"] == (32, 16)
            assert out["local"][f"{ff}.1.0.bias"] == (32,)
            assert out["local"][f"{ff}.2.0.weight"] == (8, 32)
        assert sum(1 for s in out["specs"].values() if any(s)) == 6
        # sharded after a whole step: the moments sliced with the model
        assert out["late_w0"] == (16, 8)
        np.testing.assert_allclose(out["late_losses"], out["losses"][:2],
                                   rtol=2e-5, atol=2e-6)
        _held_to_jax(out, want_losses, want)
        np.testing.assert_allclose(out["losses"], one_losses, rtol=2e-5,
                                   atol=2e-6)
        _close(out["params"], one, 2e-5, 2e-6)


def test_tensor_parallel_with_fsdp_runs(ranks, inputs):
    """merge_specs(tensor parallel, FSDP) on data=2 x model=2 against
    JAX's merge_specs run on the same mesh."""
    x, y, _ = inputs["ffno2d_fsdp"]
    jm, jp = inputs["jax"]["ffno2d_fsdp"]
    mesh = jax_make_mesh({"data": 2, "model": 2},
                         devices=jax.devices()[:WORLD])
    want_losses, want = _jax_steps(jm, jp, x, y, mesh, specs=_tp_fsdp)
    for r in range(WORLD):
        out = _case(ranks, "tp_fsdp", r)
        assert out["axes"] == ["data", "model"]
        _held_to_jax(out, want_losses, want)


def test_tensor_parallel_refuses_the_fused_feedforward(ranks):
    err = _case(ranks, "fused_conflict")["error"]
    assert err.startswith("ValueError") and "fused" in err and "'model'" in err


def test_expert_parallel_forward_matches_jax(ranks, inputs):
    (g, u, pos), _ = inputs["mgpt"]
    jm, params = inputs["jax"]["mgpt"]
    mesh = jax_make_mesh({"data": 2, "expert": 2},
                         devices=jax.devices()[:WORLD])
    sp = jax.device_put(params, specs_to_shardings(jax_ep_specs(params, mesh),
                                                   mesh))
    with mesh:
        want = np.asarray(jax.jit(jm.apply)({"params": sp}, g, u, pos))
    for r in range(WORLD):
        out = _case(ranks, "ep", r)
        sharded = [k for k, s in out["specs"].items() if any(s)]
        assert len(sharded) == 2 * 2 * 4  # blocks x moes x tensors
        assert all(out["specs"][k][0] == "expert" for k in sharded)
        assert out["w1"][0] == 2
        np.testing.assert_allclose(out["out"].numpy(), want, rtol=2e-5,
                                   atol=2e-6)


def _pipeline_grads_in_sequence(per_stage, x, r):
    """Gradients of sum(out r) through the stages applied in sequence:
    x's and the stacked leaves'."""
    leaves = {k: torch.stack([p[k] for p in per_stage]).requires_grad_()
              for k in per_stage[0]}
    xg = x.clone().requires_grad_()
    y = xg
    for i in range(len(per_stage)):
        y = W._mlp_stage({k: v[i] for k, v in leaves.items()}, y)
    (y * r).sum().backward()
    return {"x": xg.grad, **{k: v.grad for k, v in leaves.items()}}


def test_pipeline_matches_the_stages_in_sequence(ranks, inputs):
    per_stage, x, r_pp = inputs["pp"]
    want = x
    for p in per_stage:
        want = W._mlp_stage(p, want)
    grads = _pipeline_grads_in_sequence(per_stage, x, r_pp)
    for r in range(WORLD):
        out = _case(ranks, "pp", r)
        for m in (4, 8):
            np.testing.assert_allclose(out[m].numpy(), want.numpy(),
                                       rtol=1e-6, atol=1e-6)
        assert "leading dims {3} != mesh axis stage=4" in out["leading"]
        assert "batch 6 not divisible by 4 microbatches" in out["indivisible"]
        _close(out["grad"], grads, 1e-6, 1e-6)


def _jax_mlp_stage(p, x):
    return x + jnp.tanh(x @ p["w"] + p["b"])


def test_pipeline_gradients_match_jax(ranks, inputs):
    """jax.grad through JAX's pipeline_apply on {"stage": 4}: x's and the
    stacked leaves' gradients, 1e-5, on every rank."""
    per_stage, x, r_pp = inputs["pp"]
    mesh = jax_make_mesh({"stage": WORLD}, devices=jax.devices()[:WORLD])
    stacked = {k: jnp.asarray(np.stack([p[k].numpy() for p in per_stage]))
               for k in per_stage[0]}

    def loss(leaves, xx):
        return jnp.sum(jax_pipeline_apply(_jax_mlp_stage, leaves, xx, mesh)
                       * jnp.asarray(r_pp.numpy()))
    gl, gx = jax.grad(loss, argnums=(0, 1))(stacked, jnp.asarray(x.numpy()))
    want = {"x": np.asarray(gx), **{k: np.asarray(v) for k, v in gl.items()}}
    for r in range(WORLD):
        _close(_case(ranks, "pp", r)["grad"], want, 1e-5, 1e-5)


# -- the "spatial" axis ---------------------------------------------------
@pytest.fixture(scope="module")
def spatial_refs(inputs):
    """{model: (JAX's unsharded forward, its jax.grad as the port's
    state_dict)} and {route: the port's single-process gradients} of the
    batch's mean relative L2."""
    x, y, sds = inputs["spatial"]
    jax_refs = {}
    for name, bridge in (("spatial_ffno2d", _sd),
                         ("fno2d", jax_bridge.fno2d_state_dict)):
        model, params = inputs["jax"][name]

        def loss(p, model=model):
            out = model.apply({"params": p}, jnp.asarray(x))
            return jax_relative_l2(out, jnp.asarray(y)), out
        (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
        jax_refs[name] = (np.asarray(out), bridge(jax.device_get(g)))
    one = {}
    for impl in (*W.SPECTRAL_IMPLS, "fno2d"):
        model = (W._model(FNO2d, W.FNO2D_SMALL, sds["fno2d"])
                 if impl == "fno2d" else
                 W._model(FFNO2D, dict(W.SPATIAL_FFNO, spectral_impl=impl),
                          sds["ffno2d"]))
        relative_l2(model(torch.as_tensor(x)), torch.as_tensor(y)).backward()
        one[impl] = {k: p.grad.clone() for k, p in model.named_parameters()}
    return jax_refs, one


@pytest.mark.parametrize("impl", [*W.SPECTRAL_IMPLS, "fno2d"])
@pytest.mark.parametrize("mesh_name", list(W.SPATIAL_MESHES))
def test_spatially_sharded_model_matches_jax(ranks, spatial_refs, mesh_name,
                                             impl):
    """Each rank's output slab against its rows of JAX's unsharded forward
    (1e-4 / 1e-5), the reduced gradients against jax.grad (1e-3 / 1e-5)
    and against the port's single process (1e-5): S = 2 and S = 4 pin the
    two kinds of sum (a wrong one scales gradients by S)."""
    jax_refs, one = spatial_refs
    want_out, want_grads = jax_refs["fno2d" if impl == "fno2d"
                                    else "spatial_ffno2d"]
    axes = W.SPATIAL_MESHES[mesh_name]
    n_data, n_sp = axes.get("data", 1), axes["spatial"]
    b, h = want_out.shape[0] // n_data, want_out.shape[2] // n_sp
    for r in range(WORLD):
        got = _case(ranks, "spatial", r)[mesh_name, impl]
        d, s = got["coords"]
        np.testing.assert_allclose(
            got["out"].numpy(), want_out[d * b:(d + 1) * b, :,
                                         s * h:(s + 1) * h],
            rtol=1e-4, atol=1e-5)
        _close(got["grads"], want_grads, 1e-3, 1e-5)
        for k, g in one[impl].items():
            assert _rel(got["grads"][k], g) < 1e-5, k


def _spatial_place(mesh):
    return lambda a: jax.device_put(jnp.asarray(a),
                                    jax_batch_sharding(mesh, 4,
                                                       spatial_axis=2))


def test_spatial_train_steps_match_jax_and_one_process(ranks, inputs):
    """3 steps on data 2 x spatial 2 against JAX's Trainer with the batch
    placed by batch_sharding(mesh, 4, spatial_axis=2) (1e-4) and against
    one process (1e-5); 2 steps with a per-location y-normalizer (each
    rank its rows of its statistics) against one process; FFNO1D
    refused."""
    x, y, sd = inputs["ffno2d"]
    jm, jp = inputs["jax"]["ffno2d"]
    mesh = jax_make_mesh({"data": 2, "spatial": 2},
                         devices=jax.devices()[:WORLD])
    want_losses, want = _jax_steps(jm, jp, x, y, mesh,
                                   place=_spatial_place(mesh))
    one_losses, one = _single(FFNO2D, W.FFNO2D_SMALL, sd, x, y, 3)
    yn = UnitGaussianNormalizer.fit(torch.as_tensor(y))
    norm_losses, norm = _single(FFNO2D, W.FFNO2D_SMALL, sd, x, y, 2,
                                use_normalizer=True, y_normalizer=yn)
    for r in range(WORLD):
        out = _case(ranks, "spatial_train", r)
        _held_to_jax(out, want_losses, want)
        np.testing.assert_allclose(out["losses"], one_losses, rtol=1e-5)
        for k, v in one.items():
            assert _rel(out["params"][k], v) < 1e-5, k
        np.testing.assert_allclose(out["norm_losses"], norm_losses,
                                   rtol=1e-5)
        for k, v in norm.items():
            assert _rel(out["norm_params"][k], v) < 1e-5, k
        assert out["refused"].startswith("ValueError: FFNO1D does not run")


def test_multislice_mesh_rules_and_rows(ranks):
    """dcn 2 x data 2: JAX's axis names and shape, a slice's ranks
    together, the rows "dcn"-major; the defaults and the errors."""
    for r in range(WORLD):
        out = _case(ranks, "multislice", r)
        assert out["shape"] == {"dcn": 2, "data": 2}
        assert out["ranks"] == [[0, 1], [2, 3]]
        whole = np.arange(16.0).reshape(8, 2)
        np.testing.assert_array_equal(out["rows"].numpy(),
                                      whole[2 * r:2 * r + 2])
        assert out["default"] == out["inferred"] == {"dcn": 2, "data": 2}
        assert "4 ranks not divisible by 3 slices" in out["slices"]
        assert "!= 2 ranks a slice" in out["inner"]
        assert "may not name 'dcn'" in out["dcn"]
        assert out["dcn_spatial_shape"] == {"dcn": 2, "spatial": 2}


def test_multislice_train_step_matches_jax_and_one_process(ranks, inputs):
    """JAX's test_multislice_mesh_dp setup on dcn 2 x data 2 (FNO1d, the
    batch over ("dcn", "data")) against JAX's step on the same mesh (1e-4)
    and one process (2e-5 / 2e-6); FFNO2D on dcn 2 x spatial 2 against one
    process (1e-5)."""
    x1, y1, sd1 = inputs["fno1d"]
    jm, jp = inputs["jax"]["fno1d"]
    mesh = jax_make_multislice_mesh(2, {"data": 2},
                                    devices=jax.devices()[:WORLD])
    sharding = NamedSharding(mesh, PartitionSpec(("dcn", "data")))
    want_losses, want = _jax_steps(
        jm, jp, x1, y1, mesh, steps=1,
        place=lambda a: jax.device_put(jnp.asarray(a), sharding),
        bridge=jax_bridge.fno1d_state_dict)
    one_losses, one = _single(FNO1d, W.FNO1D_SMALL, sd1, x1, y1, 1)
    x, y, sd = inputs["ffno2d"]
    sp_losses, sp = _single(FFNO2D, W.FFNO2D_SMALL, sd, x, y, 1)
    for r in range(WORLD):
        out = _case(ranks, "multislice", r)
        _held_to_jax(out, want_losses, want)
        np.testing.assert_allclose(out["losses"], one_losses, rtol=2e-5,
                                   atol=2e-6)
        _close(out["params"], one, 2e-5, 2e-6)
        np.testing.assert_allclose(out["dcn_spatial_losses"], sp_losses,
                                   rtol=1e-5)
        for k, v in sp.items():
            assert _rel(out["dcn_spatial_params"][k], v) < 1e-5, k


def test_serving_over_data_matches_one_engine(ranks, inputs):
    """ServingEngine(mesh=data 4): every rank returns the whole bucket's
    predict (a 5-row request padded to it) and 2-step forecast, within
    1e-6 of one engine; a bucket of 6 rows refused."""
    xq, sd = inputs["serve"]
    one = W._engine(sd)
    one.warmup(spatial_shapes=[(16, 16)], batch_sizes=[8], rollout_steps=[2])
    want = {"predict": one.predict(xq), "padded": one.predict(xq[:5]),
            "forecast": one.forecast(xq, 2)}
    for r in range(WORLD):
        out = _case(ranks, "serve", r)
        for k, v in want.items():
            assert out[k].shape == v.shape, k
            np.testing.assert_allclose(out[k], v, rtol=1e-6, atol=1e-6,
                                       err_msg=k)
        assert out["buckets"] == [("forecast", (16, 16), 1, 8, 2),
                                  ("predict", (16, 16), 1, 8)]
        assert "bucket of 6 rows does not divide over the data extent 4" \
            in out["bad_bucket"]


def test_shard_batch_without_a_group_raises_at_make_mesh():
    """shard_batch and the trainer's mesh need a process group; without
    one the Trainer is the single-process one."""
    tr = Trainer(FFNO1D(**W.FFNO1D_SMALL), device="cpu")
    assert tr.mesh is None
    with pytest.raises(RuntimeError, match="process group"):
        shard_batch((np.zeros((2, 1)),), make_mesh())


# -- one process ----------------------------------------------------------
class _SpatialStub:
    """The mesh interface a step and shard_batch read, in one process: a
    "spatial" axis of extent 2, this process at coordinate 1."""

    mesh_dim_names = ("spatial",)

    def size(self, dim):
        return 2

    def get_local_rank(self, axis):
        return 1


def test_grid_channel_takes_the_global_rows():
    """A slab's coordinate channel is its rows of the whole grid's
    linspace, not a linspace over the slab."""
    x = torch.randn(2, 16, 8, 3)
    whole = concat_grid_2d(x)
    with spatial.using(spatial.Shard(None, 2, 1)):
        slab = concat_grid_2d(x[:, 8:])
    torch.testing.assert_close(slab, whole[:, 8:], rtol=0, atol=0)
    assert float(slab[0, 0, 0, 3]) == pytest.approx(8 / 15)


def test_shard_batch_keeps_the_rows_of_the_spatial_axis():
    x = np.arange(2 * 16 * 4, dtype=np.float32).reshape(2, 1, 16, 4)
    (xl,), w = shard_batch((x,), _SpatialStub(), spatial_axis=2)
    np.testing.assert_array_equal(xl, x[:, :, 8:])
    assert w is None
    (tl,), _ = shard_batch((torch.as_tensor(x),), _SpatialStub(),
                           spatial_axis=2)
    np.testing.assert_array_equal(tl.numpy(), x[:, :, 8:])
    with pytest.raises(ValueError, match="does not divide over spatial=2"):
        shard_batch((x[:, :, :15],), _SpatialStub(), spatial_axis=2)


@pytest.mark.parametrize("build", [
    lambda: FFNO1D(**W.FFNO1D_SMALL), lambda: FNO1d(**W.FNO1D_SMALL),
    lambda: CNO2d(1, 1, 32, **W.CNO_SMALL)], ids=["FFNO1D", "FNO1d",
                                                 "CNO2d"])
def test_models_without_spatial_sharding_are_refused(build):
    model = build()
    name = type(model).__name__
    with pytest.raises(ValueError, match=f"{name} does not run with the "
                       "grid sharded over 'spatial'"):
        Trainer(model, device="cpu", mesh=_SpatialStub())
    for ok in (FFNO2D(**W.SPATIAL_FFNO), FNO2d(**W.FNO2D_SMALL)):
        assert Trainer(ok, device="cpu", mesh=_SpatialStub()).mesh is not None


@pytest.fixture
def world_of_one(tmp_path, monkeypatch):
    import torch.distributed as dist

    monkeypatch.setenv("GLOO_SOCKET_IFNAME",
                       os.environ.get("GLOO_SOCKET_IFNAME", "lo"))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_multislice_mesh_rules_in_one_process(world_of_one):
    from resolution_pde_tpu_torch.parallel.mesh import (data_axis_size,
                                                        data_rank)

    def shape(mesh):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    m = make_multislice_mesh(1)
    assert shape(m) == {"dcn": 1, "data": 1}
    assert data_axis_size(m) == 1 and data_rank(m) == 0
    assert shape(make_multislice_mesh(1, {"data": -1, "spatial": 1})) == {
        "dcn": 1, "data": 1, "spatial": 1}
    with pytest.raises(ValueError, match="1 ranks not divisible by 2 slices"):
        make_multislice_mesh(2)
    with pytest.raises(ValueError, match="at most one axis may be -1"):
        make_multislice_mesh(1, {"data": -1, "spatial": -1})
    with pytest.raises(ValueError, match="!= 1 ranks a slice"):
        make_multislice_mesh(1, {"data": 2})
    with pytest.raises(ValueError, match="may not name 'dcn'"):
        make_multislice_mesh(1, {"dcn": 1})


# -- main_2d over two ranks -----------------------------------------------
@contextlib.contextmanager
def _cwd(path):
    old = os.getcwd()
    os.makedirs(path, exist_ok=True)
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def test_main_2d_over_two_ranks_matches_jax(tmp_path, monkeypatch):
    """main_2d at training.batch_size=4 on 2 gloo ranks against JAX's
    main_2d at training.batch_size=1 on its 8 virtual devices: both a
    global batch of 8, from JAX's initial params."""
    h5py = pytest.importorskip("h5py")
    ocp = pytest.importorskip("orbax.checkpoint")
    from resolution_pde_tpu.cli.main_2d import main as jax_main
    from resolution_pde_tpu_torch.cli import common
    from resolution_pde_tpu_torch.configs import parse_cli
    from resolution_pde_tpu_torch.train.checkpoint import save_checkpoint

    monkeypatch.delenv("SLURM_JOB_ID", raising=False)
    rng = np.random.default_rng(3)
    f = np.fft.rfft2(rng.standard_normal((10, 32, 32)))
    f[:, 5:-5, :] = 0
    f[:, :, 5:] = 0
    base = np.fft.irfft2(f, s=(32, 32)).astype(np.float32)
    with h5py.File(tmp_path / "ns.h5", "w") as fh:
        fh.create_dataset("u", data=np.stack(
            [np.roll(base, i, axis=-1) for i in range(4)], axis=1))
    argv = ["model=ffno_2d", "dataset=ns_naive",
            f"dataset.dataset_params.saved_folder={tmp_path}",
            "dataset.dataset_params.filename=ns.h5",
            "dataset.original_res=32", "dataset.max_test_resolution=32",
            "dataset.rollout_steps=2", "model.width=8", "model.n_modes=4",
            "model.n_layers=1", "model.dropout=0", "training.epochs=1"]
    with _cwd(tmp_path / "jax0"):
        out0 = jax_main(argv + ["training.epochs=0",
                                "dataset.max_test_resolution=0",
                                "dataset.rollout_steps=0"])
    raw = ocp.StandardCheckpointer().restore(
        os.path.abspath(tmp_path / "jax0" / out0["checkpoint"]), None)
    model = common.build_model(parse_cli(argv))
    model.load_state_dict(jax_bridge.ffno2d_state_dict(raw["params"]))
    init = str(tmp_path / "port_init")
    save_checkpoint(init, Trainer(model, device="cpu").init())
    with _cwd(tmp_path / "jax"):
        want = jax_main(argv + ["training.batch_size=1"])
    os.makedirs(tmp_path / "run" / "port")
    ranks = _spawn(tmp_path / "run", {
        "cases": ["cli"], "cli_argv": argv + [
            "training.batch_size=4",
            f"dataset.saved_checkpoint_path={init}"]}, 2)
    for r in range(2):
        got = _case(ranks, "cli", r)
        for k in ("train_loss", "val_loss", "lr"):
            np.testing.assert_allclose(got["history"][k],
                                       getattr(want["history"], k),
                                       rtol=1e-4)
        assert got["test_loss"] == pytest.approx(want["test_loss"], rel=1e-4)
        for key in ("super_resolution", "rollout"):
            assert sorted(got[key]) == sorted(want[key]) == [32]
            assert got[key][32] == pytest.approx(want[key][32], rel=1e-4)
    # rank 0 alone wrote the checkpoint and the tables
    port = tmp_path / "run" / "port"
    assert (port / "checkpoints" / "ffno2d" / "ns_local").is_dir()
    assert len(list((port / "runs" / "ns_ffno_2d").iterdir())) == 1
