"""Port's fused FeedForward (plain version of the CUDA kernel) against the
JAX package's Pallas kernel (interpret mode on the CPU), on the same inputs
made with numpy.

f32 tolerance rtol=2e-4, atol=2e-5: the tolerance of the existing
Pallas-vs-FFT tests; only the order of f32 sums differs.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from resolution_pde_tpu.ops.pallas.fused_ff import (  # noqa: E402
    _fwd_pallas, fused_feedforward)
from resolution_pde_tpu_torch.ops.kernels import fused_ff  # noqa: E402

DIM, FACTOR = 8, 2


def _inputs(n_layers, rows, has_ln, has_res, seed=0):
    rng = np.random.default_rng(seed)
    dims = [DIM] + [DIM * FACTOR] * (n_layers - 1) + [DIM]
    ks = [(rng.standard_normal((dims[i], dims[i + 1])) * 0.4).astype(np.float32)
          for i in range(n_layers)]
    bs = [(rng.standard_normal(dims[i + 1]) * 0.1).astype(np.float32)
          for i in range(n_layers)]
    ln = ((1.0 + 0.1 * rng.standard_normal(DIM)).astype(np.float32),
          (0.1 * rng.standard_normal(DIM)).astype(np.float32)) if has_ln else None
    x = rng.standard_normal((3, rows, DIM)).astype(np.float32)
    res = rng.standard_normal((3, rows, DIM)).astype(np.float32) if has_res else None
    return x, ks, bs, ln, res


def _jax(x, ks, bs, ln, res, approx):
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    return np.asarray(fused_feedforward(
        j(x), [j(k) for k in ks], [j(b) for b in bs],
        None if ln is None else tuple(j(a) for a in ln), j(res),
        approx_gelu=approx, compute_dtype=jnp.float32, interpret=True))


def _torch(x, ks, bs, ln, res, approx, dtype=torch.float32):
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    return fused_ff.fused_feedforward(
        t(x), [t(k) for k in ks], [t(b) for b in bs],
        None if ln is None else tuple(t(a) for a in ln), t(res),
        approx_gelu=approx, compute_dtype=dtype)


@pytest.mark.parametrize("n_layers", [1, 3])
@pytest.mark.parametrize("has_ln", [True, False])
@pytest.mark.parametrize("approx", [True, False])
@pytest.mark.parametrize("has_res", [True, False])
def test_fused_ff_reference_matches_jax(n_layers, has_ln, approx, has_res):
    # 3 x 37 = 111 rows: a multiple of no row tile of either kernel
    x, ks, bs, ln, res = _inputs(n_layers, 37, has_ln, has_res)
    want = _jax(x, ks, bs, ln, res, approx)
    got = _torch(x, ks, bs, ln, res, approx)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


def test_fused_ff_bf16_reference_matches_jax():
    """bf16 compute: both round the hidden activations to bf16 at the same
    points, so they differ by rounding flips only (bound: relative L2 2e-2)."""
    x, ks, bs, ln, res = _inputs(3, 37, True, True, seed=1)
    j = lambda a: jnp.asarray(a)  # noqa: E731
    want = np.asarray(fused_feedforward(
        j(x).astype(jnp.bfloat16), [j(k) for k in ks], [j(b) for b in bs],
        tuple(j(a) for a in ln), j(res).astype(jnp.bfloat16),
        approx_gelu=True, compute_dtype=jnp.bfloat16,
        interpret=True).astype(jnp.float32))
    t = torch.from_numpy
    got = fused_ff.fused_feedforward(
        t(x).bfloat16(), [t(k) for k in ks], [t(b) for b in bs],
        tuple(t(a) for a in ln), t(res).bfloat16(), approx_gelu=True,
        compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    rel = np.linalg.norm(got.float().numpy() - want) / np.linalg.norm(want)
    assert rel <= 2e-2


def test_fused_ff_save_acts_raises():
    """The backward refuses saved pre-activations that do not match the
    chain: without LayerNorm the forward saves all but the last layer's."""
    x, ks, bs, ln, res = _inputs(2, 4, False, False)
    t = torch.from_numpy
    _, zs = fused_ff.fused_feedforward_reference(
        t(x), [t(k) for k in ks], [t(b) for b in bs], save_acts=True,
        compute_dtype=torch.float32)
    assert len(zs) == 1
    g = torch.ones(x.shape)
    with pytest.raises(ValueError, match="zs_saved"):
        fused_ff.fused_feedforward_bwd_reference(
            t(x), g, [t(k) for k in ks], [t(b) for b in bs],
            compute_dtype=torch.float32, zs_saved=zs * 2)


@pytest.mark.parametrize("save", [False, True])
@pytest.mark.parametrize("has_res", [True, False])
@pytest.mark.parametrize("has_ln", [True, False])
def test_fused_ff_bf16_reference_matches_pallas_ragged(has_ln, has_res, save):
    """The bf16 plain forward that the CUDA kernel is held to on the card,
    against the Pallas forward kernel (interpret mode) at widths no
    fragment divides, 24 -> 40 -> 40 -> 24, 40 rows: the output and, with
    save_acts, each saved pre-activation. Both round every hidden
    activation (and the saved ones) to bf16 at the same points, so they
    differ by rounding flips only (bound: relative L2 1e-2)."""
    rng = np.random.default_rng(2)
    dims = [24, 40, 40, 24]
    ks = [(rng.standard_normal((a, b)) * a ** -0.5).astype(np.float32)
          for a, b in zip(dims, dims[1:])]
    bs = [(0.1 * rng.standard_normal(d)).astype(np.float32) for d in dims[1:]]
    ln = ((1.0 + 0.1 * rng.standard_normal(24)).astype(np.float32),
          (0.1 * rng.standard_normal(24)).astype(np.float32)) if has_ln else None
    x = rng.standard_normal((40, 24)).astype(np.float32)
    res = rng.standard_normal((40, 24)).astype(np.float32) if has_res else None
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    want = _fwd_pallas(
        j(x).astype(jnp.bfloat16), [j(k) for k in ks], [j(b) for b in bs],
        None if ln is None else tuple(j(a) for a in ln),
        None if res is None else j(res).astype(jnp.bfloat16), n_layers=3,
        has_ln=has_ln, approx_gelu=True, has_residual=has_res,
        cd=jnp.bfloat16, interpret=True, save_zs=save)
    want, want_zs = want if save else (want, ())
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    got = fused_ff.fused_feedforward_reference(
        t(x).bfloat16(), [t(k) for k in ks], [t(b) for b in bs],
        None if ln is None else tuple(t(a) for a in ln),
        None if res is None else t(res).bfloat16(), approx_gelu=True,
        compute_dtype=torch.bfloat16, save_acts=save)
    got, got_zs = got if save else (got, [])
    rel = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(b)  # noqa: E731
    f32 = lambda a: np.asarray(a.astype(jnp.float32))  # noqa: E731
    assert got.dtype == torch.bfloat16 and got.shape == (40, 24)
    assert rel(got.float().numpy(), f32(want)) <= 1e-2
    assert len(got_zs) == len(want_zs) == ((3 if has_ln else 2) if save else 0)
    for g, w in zip(got_zs, want_zs):
        assert g.dtype == torch.bfloat16
        assert rel(g.float().numpy(), f32(w)) <= 1e-2


# -- chains wider than the train shape's ---------------------------------


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_wide_chain_f32_matches_jax():
    """A factor-4 chain at width 160 (160 -> 640 -> 640 -> 160, LayerNorm,
    residual), whose hidden layers the f32 kernels run in column chunks of
    256: the plain f32 forward and backward, which the kernels are held to
    on the card, against the JAX kernel (interpret mode) and its custom
    VJP at 12 rows. Only the order of f32 sums differs (bound: relative L2
    1e-5 for the output and every gradient)."""
    rng = np.random.default_rng(160)
    dims = [160, 640, 640, 160]
    ks = [(rng.standard_normal((a, b)) * a ** -0.5).astype(np.float32)
          for a, b in zip(dims, dims[1:])]
    bs = [(0.1 * rng.standard_normal(d)).astype(np.float32) for d in dims[1:]]
    ln = ((1.0 + 0.1 * rng.standard_normal(160)).astype(np.float32),
          (0.1 * rng.standard_normal(160)).astype(np.float32))
    x = rng.standard_normal((12, 160)).astype(np.float32)
    res = rng.standard_normal((12, 160)).astype(np.float32)
    g = rng.standard_normal((12, 160)).astype(np.float32)
    j = jnp.asarray

    def f(x_, ks_, bs_, ln_, res_):
        return fused_feedforward(x_, ks_, bs_, ln_, res_, approx_gelu=True,
                                 compute_dtype=jnp.float32, interpret=True)

    want, vjp = jax.vjp(f, j(x), [j(k) for k in ks], [j(b) for b in bs],
                        tuple(j(a) for a in ln), j(res))
    wdx, wdks, wdbs, wdln, _ = vjp(j(g))
    t = torch.from_numpy
    tks, tbs, tln = [t(k) for k in ks], [t(b) for b in bs], tuple(
        t(a) for a in ln)
    kw = dict(approx_gelu=True, compute_dtype=torch.float32)
    got = fused_ff.fused_feedforward_reference(t(x), tks, tbs, tln, t(res),
                                               **kw)
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-5
    dx, dks, dbs, dln = fused_ff.fused_feedforward_bwd_reference(
        t(x), t(g), tks, tbs, tln, **kw)
    pairs = [(dx, wdx), *zip(dks, wdks), *zip(dbs, wdbs), *zip(dln, wdln)]
    for a, b in pairs:
        assert a.shape == b.shape
        assert _rel(a.numpy(), np.asarray(b)) <= 1e-5


@pytest.mark.parametrize("width,cd,rows", [
    (64, torch.float32, 32), (64, torch.bfloat16, 64),   # the train shape
    (160, torch.float32, 8), (192, torch.float32, 8), (256, torch.float32, 8),
    (160, torch.bfloat16, 16), (256, torch.bfloat16, 16),
    (320, torch.float32, 8), (320, torch.bfloat16, 32),
    (512, torch.float32, 8), (512, torch.bfloat16, 16),
    (640, torch.float32, None), (1024, torch.bfloat16, None)])
def test_backward_tile_rows_of_factor4_chains(width, cd, rows):
    """The backward kernel's tile rows for factor-4 chains, from the
    launcher's mirror of its planner (chip_smoke.py holds the mirror to
    the planner): the f32 ring sized to a column chunk of 256 leaves 8-row
    tiles up to width 256; past 256 not even the least tile fits beside
    its pre-activations, which then go to device memory, so widths 320 and
    512 take tiles again (8 rows in f32; 32 and 16 in bf16). A chain that
    fits no tile even so (f32 at 640, bf16 at 1024) raises a ValueError
    naming the shared memory it needs, before any launch, also from the
    launcher on tensors of any device."""
    dims = [width, 4 * width, 4 * width, width]
    if rows is not None:
        assert fused_ff.backward_tile_rows(dims, True, cd) == rows
        return
    with pytest.raises(ValueError, match="shared memory"):
        fused_ff.backward_tile_rows(dims, True, cd)
    rng = np.random.default_rng(width)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    ks = [t(a, b) for a, b in zip(dims, dims[1:])]
    bs = [t(d) for d in dims[1:]]
    with pytest.raises(ValueError, match="shared memory"):
        fused_ff.fused_feedforward_bwd(t(4, width), t(4, width), ks, bs,
                                       (t(width), t(width)),
                                       compute_dtype=cd)


def test_wide_chain_320_f32_backward_matches_jax():
    """The plain f32 backward, which the kernel is held to on the card, of
    a factor-4 chain at width 320 (320 -> 1280 -> 1280 -> 320, LayerNorm:
    the first width whose pre-activations the kernel keeps in device
    memory) against jax.vjp of the JAX fused FeedForward (interpret mode)
    at 4 rows, recomputed and from the saved pre-activations. Only the
    order of f32 sums differs (bound: relative L2 1e-5 for dx and every
    gradient)."""
    rng = np.random.default_rng(320)
    dims = [320, 1280, 1280, 320]
    ks = [(rng.standard_normal((a, b)) * a ** -0.5).astype(np.float32)
          for a, b in zip(dims, dims[1:])]
    bs = [(0.1 * rng.standard_normal(d)).astype(np.float32) for d in dims[1:]]
    ln = ((1.0 + 0.1 * rng.standard_normal(320)).astype(np.float32),
          (0.1 * rng.standard_normal(320)).astype(np.float32))
    x = rng.standard_normal((4, 320)).astype(np.float32)
    g = rng.standard_normal((4, 320)).astype(np.float32)
    j = jnp.asarray

    def f(x_, ks_, bs_, ln_):
        return fused_feedforward(x_, ks_, bs_, ln_, approx_gelu=True,
                                 compute_dtype=jnp.float32, interpret=True)

    _, vjp = jax.vjp(f, j(x), [j(k) for k in ks], [j(b) for b in bs],
                     tuple(j(a) for a in ln))
    wdx, wdks, wdbs, wdln = vjp(j(g))
    t = torch.from_numpy
    tks, tbs, tln = [t(k) for k in ks], [t(b) for b in bs], tuple(
        t(a) for a in ln)
    kw = dict(approx_gelu=True, compute_dtype=torch.float32)
    _, zs = fused_ff.fused_feedforward_reference(t(x), tks, tbs, tln,
                                                 save_acts=True, **kw)
    for saved in (None, zs):
        dx, dks, dbs, dln = fused_ff.fused_feedforward_bwd_reference(
            t(x), t(g), tks, tbs, tln, zs_saved=saved, **kw)
        pairs = [(dx, wdx), *zip(dks, wdks), *zip(dbs, wdbs),
                 *zip(dln, wdln)]
        for a, b in pairs:
            assert a.shape == b.shape
            assert _rel(a.numpy(), np.asarray(b)) <= 1e-5


# The forward planner's plans by hand (csrc/fused_ff.cu ``plan``): bf16 rows
# of pad16(widest) + 8 bf16 (h_ld), the last layer's f32 sums in rows of
# pad16(c_out) + 8 (z_ld) followed by the residual tile in the same buffer,
# two buffers, and a ring of 2 stages x 32 rows x (the widest pass + 8)
# bf16; a block has 232,448 bytes.
# - 64 -> 256 -> 256 -> 64 (the bench chain), 64 rows: buffers of
#   max(64 x 264 x 2, 64 x 72 x 4 + 64 x 64 x 2) = 33,792, ring of
#   2 x 32 x 264 x 2 = 33,792 (wide passes of 256): 101,376 bytes.
# - 128 -> 512 -> 512 -> 128, 64 rows: buffers of 64 x 520 x 2 = 66,560,
#   the same ring: 166,912.
# - 512 -> 2048 -> 2048 -> 512: 64 rows need 2 x 263,168 and 32 rows
#   2 x 131,584 + 17,408; 16 rows (thin 16 x 16 warp tiles, passes of 128
#   columns) 2 x 16 x 2056 x 2 + 2 x 32 x 136 x 2 = 148,992. In f32, rows
#   of (2048 + 27) // 32 x 32 + 4 = 2052 floats and a ring of
#   2 x 32 x 256 floats: 8 rows, 2 x 8 x 2052 x 4 + 65,536 = 196,864.
# - 837 -> 3348 -> 3348 -> 837: 16 rows need 2 x 16 x 3368 x 2 + 17,408 =
#   232,960 bytes; 836 -> 3344 needs 231,936 and fits.
@pytest.mark.parametrize("dims,cd,io,plan", [
    ([64, 256, 256, 64], torch.bfloat16, torch.bfloat16, ("mma", 64)),
    ([64, 256, 256, 64], torch.float32, torch.float32, ("f32_tiles", 64)),
    ([128, 512, 512, 128], torch.bfloat16, torch.bfloat16, ("mma", 64)),
    ([512, 2048, 2048, 512], torch.bfloat16, torch.bfloat16, ("mma", 16)),
    ([512, 2048, 2048, 512], torch.bfloat16, torch.float32, ("mma", 16)),
    ([512, 2048, 2048, 512], torch.float32, torch.float32, ("f32_tiles", 8)),
    ([836, 3344, 3344, 836], torch.bfloat16, torch.bfloat16, ("mma", 16)),
    ([837, 3348, 3348, 837], torch.bfloat16, torch.bfloat16, None)],
    ids=["bench-bf16", "bench-f32", "w128-bf16", "w512-bf16", "w512-bf16-f32io",
         "w512-f32", "w836-bf16", "w837-bf16-raises"])
def test_forward_tile_rows_by_hand(dims, cd, io, plan):
    """The forward kernel's route and tile rows for the chains above, from
    the launcher's mirror of its planner (chip_smoke.py holds the mirror to
    the planner); a chain no tile fits raises a ValueError naming its
    widths and bytes, before any launch, also from the launcher on
    tensors of any device."""
    if plan is not None:
        assert fused_ff.forward_tile_rows(dims, True, True, cd, io) == plan
        return
    with pytest.raises(ValueError, match=r"837.*232960 bytes"):
        fused_ff.forward_tile_rows(dims, True, True, cd, io)
    ks = [torch.zeros(a, b) for a, b in zip(dims, dims[1:])]
    bs = [torch.zeros(d) for d in dims[1:]]
    x = torch.zeros(4, dims[0], dtype=io)
    with pytest.raises(ValueError, match="shared memory"):
        fused_ff.fused_feedforward_fwd(x, ks, bs, None, x.clone(),
                                       compute_dtype=cd)
