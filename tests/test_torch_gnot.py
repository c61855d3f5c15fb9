"""The port's MoE-GPT / GNOT path against the JAX package's on the CPU:
LinearAttention (self and cross, one and two heads),
MoECrossAttentionBlock in both expert layouts ('loop', experts stacked
on the last axis; 'stacked', one (m, c, i) tensor contracted
'mbtc,btm'), MoEGPTNO with the horizontal Fourier embedding and
GNOTOperator on a 64-node point cloud, each on the JAX parameters
carried over by utils.jax_bridge: the forward and every parameter's
gradient of a weighted sum of the output. The GNOT utilities (weighted
Lp losses, the unit transformers) against JAX's; grid_to_point_cloud,
knn_edges, radius_edges and GraphDataset byte for byte,
point_cloud_markov_dataset (from an HDF5 file and from arrays held in
memory) byte for byte unencoded. Then ``main_2d model=mgpt
dataset=ns_gnot`` at a tiny width through both command lines, from the
same initial weights.

Tolerance: relative L2 1e-4 in f32 on the outputs and each parameter's
gradient (test_torch_transformers.check_against_jax); the utilities
1e-6; the command lines' losses 1e-4 relative.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
h5py = pytest.importorskip("h5py")
import jax.numpy as jnp  # noqa: E402

from resolution_pde_tpu.cli.main_2d import main as jax_main  # noqa: E402
from resolution_pde_tpu.data import factories as jfactories  # noqa: E402
from resolution_pde_tpu.data import graph as jgraph  # noqa: E402
from resolution_pde_tpu.models import mgpt as jmgpt  # noqa: E402
from resolution_pde_tpu.utils import gnot as jgnot  # noqa: E402
from resolution_pde_tpu_torch.cli.main_2d import main  # noqa: E402
from resolution_pde_tpu_torch.configs import instantiate_dataset  # noqa: E402
from resolution_pde_tpu_torch.data import graph  # noqa: E402
from resolution_pde_tpu_torch.data.io import files_in_memory  # noqa: E402
from resolution_pde_tpu_torch.models import get_model, mgpt  # noqa: E402
from resolution_pde_tpu_torch.utils import gnot, jax_bridge  # noqa: E402
from test_torch_burgers_darcy_data import _check  # noqa: E402
from test_torch_transformers import (JAX_DEVICES, RTOL, _cwd,  # noqa: E402
                                     _params, _x, check_against_jax,
                                     port_checkpoint_of_jax_init)

UTIL_TOL = 1e-6


def _strip(prefix: str, to_state_dict):
    return lambda p: {k[len(prefix):]: v
                      for k, v in to_state_dict(p).items()}


@pytest.mark.parametrize("n_head,cross", [(1, False), (2, True)])
def test_linear_attention_matches_jax(n_head, cross):
    rng = np.random.default_rng(n_head)
    x, y = _x(rng, (2, 10, 8)), _x(rng, (2, 7, 8))
    jargs = (x, y) if cross else (x,)
    jmod = jmgpt.LinearAttention(8, n_head)
    params = _params(jmod, n_head, *jargs)

    def sd(p):
        out = {}
        for name in ("query", "key", "value", "proj"):
            out.update(jax_bridge._dense(p[name], name))
        return out

    check_against_jax(jmod, params, jargs, mgpt.LinearAttention(8, n_head),
                      sd, tuple(torch.from_numpy(a) for a in jargs))


@pytest.mark.parametrize("expert_impl", ["loop", "stacked"])
def test_moe_block_matches_jax(expert_impl):
    rng = np.random.default_rng(3)
    x, y, pos = _x(rng, (2, 12, 8)), _x(rng, (2, 9, 8)), _x(rng, (2, 12, 2))
    cfg = dict(n_head=2, n_experts=3, expert_impl=expert_impl)
    jmod = jmgpt.MoECrossAttentionBlock(8, 16, **cfg)
    params = _params(jmod, 3, x, y, pos)
    check_against_jax(jmod, params, (x, y, pos),
                      mgpt.MoECrossAttentionBlock(8, 16, **cfg),
                      _strip("b.", lambda p: jax_bridge._moe_block(p, "b")),
                      tuple(torch.from_numpy(a) for a in (x, y, pos)))


@pytest.mark.parametrize("expert_impl", ["loop", "stacked"])
def test_mgpt_with_fourier_embedding_matches_jax(expert_impl):
    rng = np.random.default_rng(4)
    g, u, pos = _x(rng, (2, 10, 3)), _x(rng, (2, 6, 2)), _x(rng, (2, 10, 2))
    cfg = dict(trunk_size=3, branch_size=2, output_size=2, n_layers=2,
               n_hidden=8, n_experts=2, horiz_fourier_dim=2,
               expert_impl=expert_impl)
    jmod = jmgpt.MoEGPTNO(**cfg)
    params = _params(jmod, 4, g, u, pos)
    check_against_jax(jmod, params, (g, u, pos), mgpt.MoEGPTNO(**cfg),
                      jax_bridge.mgpt_state_dict,
                      tuple(torch.from_numpy(a) for a in (g, u, pos)))


def test_horizontal_fourier_embedding_matches_jax():
    x = _x(np.random.default_rng(5), (2, 7, 3)) * 3
    want = jmgpt.horizontal_fourier_embedding(jnp.asarray(x), 3)
    got = mgpt.horizontal_fourier_embedding(torch.from_numpy(x), 3)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=UTIL_TOL, atol=UTIL_TOL)


def test_gnot_operator_matches_jax():
    """64 nodes (an 8x8 point cloud), n_hidden 16, as the ns_gnot rows."""
    u = _x(np.random.default_rng(6), (2, 8, 8))
    feats, pos = graph.grid_to_point_cloud(u)
    x = np.concatenate([feats, np.broadcast_to(pos, (2,) + pos.shape)], -1)
    cfg = dict(n_hidden=16, n_layers=2, n_head=2)
    jmod = jmgpt.GNOTOperator(**cfg)
    params = _params(jmod, 6, x)
    check_against_jax(jmod, params, (x,), mgpt.GNOTOperator(**cfg),
                      jax_bridge.gnot_state_dict, (torch.from_numpy(x),))
    for name in ("GNOTOperator", "MoEGPTNO", "models.mgpt.MoEGPTNO"):
        assert get_model(name) is getattr(mgpt, name.rsplit(".", 1)[-1])


# ---------------------------------------------------------------------------
# utilities and the point-cloud data path
# ---------------------------------------------------------------------------

def test_gnot_losses_and_transformers_match_jax():
    rng = np.random.default_rng(7)
    pred, target = _x(rng, (3, 20, 2)), _x(rng, (3, 20, 2))
    for p in (1, 2):
        for c in (0, 1):
            for name in ("weighted_lp_rel_loss", "weighted_lp_loss"):
                got = getattr(gnot, name)(torch.from_numpy(pred),
                                          torch.from_numpy(target), p, c)
                want = getattr(jgnot, name)(pred, target, p, c)
                assert float(got) == pytest.approx(float(want),
                                                   rel=UTIL_TOL), name
    x = _x(rng, (4, 5, 3)) * 2 + 1
    for cls in ("UnitTransformer", "PointWiseUnitTransformer"):
        t, jt = getattr(gnot, cls).fit(x), getattr(jgnot, cls).fit(x)
        np.testing.assert_allclose(t.mean, jt.mean, rtol=UTIL_TOL)
        np.testing.assert_allclose(t.std, jt.std, rtol=UTIL_TOL)
        enc = t.encode(torch.from_numpy(x))
        np.testing.assert_allclose(enc, jt.encode(x), rtol=UTIL_TOL,
                                   atol=UTIL_TOL)
        np.testing.assert_allclose(t.decode(enc), x, rtol=UTIL_TOL,
                                   atol=UTIL_TOL)
        np.testing.assert_allclose(t.encode(x), jt.encode(x), rtol=UTIL_TOL,
                                   atol=UTIL_TOL)  # numpy in, numpy out
    xs = gnot.MultipleTensors([x, pred])
    assert len(xs) == 2 and xs[1] is pred and list(xs)[0] is x


def test_point_cloud_and_edges_equal_jax():
    rng = np.random.default_rng(8)
    u = _x(rng, (3, 6, 5))
    for a, b in zip(graph.grid_to_point_cloud(u),
                    jgraph.grid_to_point_cloud(u)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    pos = _x(rng, (300, 2))
    for k in (1, 5):
        assert (graph.knn_edges(pos, k).tobytes()
                == jgraph.knn_edges(pos, k).tobytes())
    assert (graph.radius_edges(pos, 0.3).tobytes()
            == jgraph.radius_edges(pos, 0.3).tobytes())
    with pytest.raises(ValueError, match="k=300"):
        graph.knn_edges(pos, 300)


@pytest.mark.parametrize("kw", [
    {}, dict(normalize_y=True, edges=("knn", 3)),
    dict(edges=("radius", 0.25))], ids=["plain", "normalized_knn", "radius"])
def test_graph_dataset_equals_jax(kw):
    rng = np.random.default_rng(9)
    u_in, u_out = _x(rng, (4, 6, 6)), _x(rng, (4, 6, 6))
    got = graph.build_dgl_graph_dataset(u_in, u_out, **kw)
    want = jgraph.build_dgl_graph_dataset(u_in, u_out, **kw)
    assert len(got) == len(want) == 4
    for a, b in zip(got[1] + (got.edges,), want[1] + (want.edges,)):
        if b is None:
            assert a is None
        else:
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    if kw.get("normalize_y"):
        np.testing.assert_allclose(
            got.y_normalizer.decode(got.y), u_out.reshape(4, 36, 1),
            rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="edges must be"):
        graph.GraphDataset(got.x, got.y, edges=("grid", 1))


def _ns_frames(n=6, t=4, h=8, seed=10):
    return np.random.default_rng(seed).standard_normal(
        (n, t, h, h)).astype(np.float32)


@pytest.mark.parametrize("source,normalize", [("h5", True),
                                              ("in_memory", False),
                                              ("in_memory", True)])
def test_point_cloud_markov_dataset_matches_jax(source, normalize,
                                                tmp_path):
    """The factory's tuple against JAX's on one HDF5 file (strided by 2 in
    space and time, as ns_gnot.yaml's keys allow), and built from the
    same arrays held in memory (the card's route: no h5py there): the
    splits byte for byte where unencoded, to 1e-4 encoded, and the
    normalizers' statistics to 1e-6 (test_torch_burgers_darcy_data.
    _check)."""
    u = _ns_frames(t=7, h=16)
    with h5py.File(tmp_path / "ns.h5", "w") as f:
        f.create_dataset("u", data=u)
    kw = dict(filename="ns.h5", saved_folder=str(tmp_path),
              reduced_resolution=2, reduced_resolution_t=2,
              data_normalizer=normalize)
    want = jfactories.point_cloud_markov_dataset(**kw)
    params = {"_target_": "point_cloud_markov_dataset", **kw}
    if source == "h5":
        got = instantiate_dataset(params)
    else:
        held = str(tmp_path / "held")
        with files_in_memory({os.path.join(held, "ns.h5"): u}):
            got = instantiate_dataset(dict(params, saved_folder=held))
    assert got[0].x.shape[1:] == (64, 3) and got[0].y.shape[1:] == (64, 1)
    assert len(got[0]) + len(got[1]) + len(got[2]) == 6 * 3
    _check(got, want, exact=True)


# ---------------------------------------------------------------------------
# main_2d model=mgpt dataset=ns_gnot
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gnot_dir(tmp_path_factory):
    """10 trajectories x 5 frames at 8² (64 nodes): smooth fields shifted
    in time."""
    d = tmp_path_factory.mktemp("gnot_cli")
    rng = np.random.default_rng(12)
    f = np.fft.rfft2(rng.standard_normal((10, 8, 8)))
    f[:, 3:-3, :] = 0
    f[:, :, 3:] = 0
    base = np.fft.irfft2(f, s=(8, 8)).astype(np.float32)
    u = np.stack([np.roll(base, i, axis=-1) for i in range(5)], axis=1)
    with h5py.File(d / "ns.h5", "w") as fh:
        fh.create_dataset("u", data=u)
    return d


def _gnot_argv(d, *extra):
    return ["model=mgpt", "dataset=ns_gnot",
            f"dataset.dataset_params.saved_folder={d}",
            "dataset.dataset_params.filename=ns.h5",
            "model.n_hidden=16", "model.n_layers=1", *extra]


def test_main_2d_mgpt_matches_jax(gnot_dir, tmp_path, monkeypatch):
    """main_2d model=mgpt dataset=ns_gnot (GNOTOperator at n_hidden 16,
    one block, on 64-node point clouds; ns_gnot.yaml has no sweep and no
    rollout), 2 epochs from JAX's initial weights, against JAX's main_2d:
    the loss history and the test loss."""
    monkeypatch.delenv("SLURM_JOB_ID", raising=False)
    init = port_checkpoint_of_jax_init(
        _gnot_argv(gnot_dir), (2, 64, 3), jax_bridge.gnot_state_dict,
        str(tmp_path / "port_init"))
    run = ["training.epochs=2"]
    with _cwd(tmp_path / "jax"):
        want = jax_main(_gnot_argv(gnot_dir, *run, "training.batch_size=2"))
    with _cwd(tmp_path / "port"):
        got = main(_gnot_argv(gnot_dir, *run,
                              f"training.batch_size={2 * JAX_DEVICES}",
                              f"dataset.saved_checkpoint_path={init}"),
                   device="cpu")
    for k in ("train_loss", "val_loss", "lr"):
        np.testing.assert_allclose(getattr(got["history"], k),
                                   getattr(want["history"], k), rtol=RTOL)
    assert got["history"].train_loss[1] < got["history"].train_loss[0]
    assert got["test_loss"] == pytest.approx(want["test_loss"], rel=RTOL)
    assert got["super_resolution"] == want["super_resolution"] == {}
    assert got["rollout"] == want["rollout"] == {}
    assert got["n_params"] == want["n_params"]
