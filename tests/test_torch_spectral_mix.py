"""Port's spectral axis pass (plain version of the CUDA kernel), its packed
weight and DFT factors, and the port's factorized spectral convs, against
the JAX package (Pallas kernels in interpret mode on the CPU), on the same
inputs made with numpy.

f32 tolerance rtol=2e-4, atol=2e-5: the tolerance of the existing
Pallas-vs-FFT tests; only the order of f32 sums differs. bf16: relative L2
2e-2, since bf16 rounds at different places in the two frameworks.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from resolution_pde_tpu.ops import spectral as jspec  # noqa: E402
from resolution_pde_tpu.ops.pallas import spectral_mix as jmix  # noqa: E402
from resolution_pde_tpu.ops.pallas import spectral_mix2 as jmix2  # noqa: E402
from resolution_pde_tpu_torch.ops import spectral as tspec  # noqa: E402
from resolution_pde_tpu_torch.ops.kernels import spectral_mix as tmix  # noqa: E402

F32 = dict(rtol=2e-4, atol=2e-5)

# (n, n_modes): m = min(n_modes, n // 2 + 1)
MODE_CASES = [
    (16, 5),    # odd m
    (16, 12),   # m clipped to n//2+1 = 9 with n even: Nyquist weight 1
    (12, 7),    # m == n//2+1 exactly, even n
    (15, 6),    # odd n
    (15, 10),   # odd n, clipped to 8: no Nyquist bin
]


def _weight(rng, c, o, modes):
    return (rng.standard_normal((c, o, modes, 2)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("n,m", [(16, 5), (16, 9), (12, 7), (15, 8), (24, 13),
                                 (7, 4)])
@pytest.mark.parametrize("norm", ["ortho", "backward"])
def test_dft_matrices_bit_exact(n, m, norm):
    for a, b in zip(tspec._dft_matrices(n, m, norm),
                    jspec._dft_matrices(n, m, norm)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("m", [3, 5, 8])
def test_pack_mix_weight_bit_exact(m):
    w = _weight(np.random.default_rng(m), 4, 3, 8)
    got = tmix.pack_mix_weight(torch.from_numpy(w), m).numpy()
    want = np.asarray(jmix2.pack_mix_weight(jnp.asarray(w), m))
    assert got.shape == (m, 8, 6)
    np.testing.assert_array_equal(got, want)


# ragged shapes of the bf16 kernel: n not a multiple of 16, m = 17 (2m = 34
# packed modes), C = 24 -> O = 40 channels
RAGGED_CASES = [(40, 17, 24, 40), (32, 17, 24, 40)]


def _ids(cases):
    return [f"{n}-{k}" if (c, o) == (4, 3) else f"{n}-{k}-{c}-{o}"
            for n, k, c, o in cases]


PASS_CASES = [(n, k, 4, 3) for n, k in MODE_CASES] + RAGGED_CASES


@pytest.mark.parametrize("n,n_modes,c,o", PASS_CASES, ids=_ids(PASS_CASES))
def test_spectral_pass_reference_matches_jax_kernels(n, n_modes, c, o):
    rng = np.random.default_rng(n * 100 + n_modes)
    rows = 5
    x = rng.standard_normal((rows, n, c)).astype(np.float32)
    w = _weight(rng, c, o, n_modes)
    m = min(n_modes, n // 2 + 1)
    f2, i2 = tmix.packed_factors(n, m, "ortho", torch.device("cpu"))
    got = tmix.spectral_pass_reference(
        torch.from_numpy(x), f2, i2, tmix.pack_mix_weight(torch.from_numpy(w), m),
        torch.float32).numpy()
    packed = np.asarray(jmix2.packed_spectral_mix_1d(
        jnp.asarray(x), jnp.asarray(w), n_modes, interpret=True,
        compute_dtype=jnp.float32))
    unpacked = np.asarray(jmix.truncated_spectral_mix_1d(
        jnp.asarray(x), jnp.asarray(w), n_modes, interpret=True))
    assert got.shape == (rows, n, o)
    np.testing.assert_allclose(got, packed, **F32)
    np.testing.assert_allclose(got, unpacked, **F32)


def _conv_inputs(seed, b=2, h=12, w=16, c=4, modes=6):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, w, c)).astype(np.float32),
            _weight(rng, c, c, modes), _weight(rng, c, c, modes), modes)


@pytest.mark.parametrize("h,w,modes", [(12, 16, 6), (16, 24, 5), (10, 7, 9)])
def test_factorized_convs_match_jax(h, w, modes):
    """Non-square grids with a different m per axis: a swap of weight_y
    (along W) and weight_x (along H) fails here."""
    x, wy, wx, modes = _conv_inputs(h * w, h=h, w=w, modes=modes)
    jx, jwy, jwx = jnp.asarray(x), jnp.asarray(wy), jnp.asarray(wx)
    tx, twy, twx = (torch.from_numpy(a) for a in (x, wy, wx))
    want = np.asarray(jspec.factorized_spectral_conv_2d(jx, jwy, jwx, modes))
    np.testing.assert_allclose(
        tspec.factorized_spectral_conv_2d(tx, twy, twx, modes).numpy(),
        want, **F32)
    np.testing.assert_allclose(
        tspec.factorized_spectral_conv_2d_pallas(tx, twy, twx, modes).numpy(),
        np.asarray(jspec.factorized_spectral_conv_2d_pallas(
            jx, jwy, jwx, modes, interpret=True)), **F32)
    np.testing.assert_allclose(
        tmix.factorized_spectral_conv_2d_pallas2(
            tx, twy, twx, modes, compute_dtype=torch.float32).numpy(),
        np.asarray(jmix2.factorized_spectral_conv_2d_pallas2(
            jx, jwy, jwx, modes, compute_dtype=jnp.float32,
            interpret=True)), **F32)
    # and the fused path is the FFT path
    np.testing.assert_allclose(
        tspec.factorized_spectral_conv_2d_pallas(tx, twy, twx, modes).numpy(),
        want, **F32)


def test_factorized_conv_pallas2_bf16_matches_jax():
    x, wy, wx, modes = _conv_inputs(7, h=16, w=24, modes=9)
    want = np.asarray(jmix2.factorized_spectral_conv_2d_pallas2(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(wy), jnp.asarray(wx),
        modes, compute_dtype=jnp.bfloat16, interpret=True).astype(jnp.float32))
    got = tmix.factorized_spectral_conv_2d_pallas2(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(wy),
        torch.from_numpy(wx), modes, compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    rel = np.linalg.norm(got.float().numpy() - want) / np.linalg.norm(want)
    assert rel <= 2e-2


def test_axis_pass_accumulates_in_place():
    x, wy, _, modes = _conv_inputs(3)
    tx = torch.from_numpy(x)
    m = min(modes, x.shape[2] // 2 + 1)
    wab = tmix.mix_blocks(torch.from_numpy(wy), m)
    once = tmix.spectral_axis_pass(tx, wab, 2, "ortho", torch.float32)
    acc = torch.ones_like(once)
    out = tmix.spectral_axis_pass(tx, wab, 2, "ortho", torch.float32,
                                  acc=acc)
    assert out is acc
    np.testing.assert_array_equal(out.numpy(), (once + 1).numpy())
    with pytest.raises(ValueError):
        tmix.spectral_axis_pass(tx, wab, 3, "ortho", torch.float32)


@pytest.mark.parametrize("m", [3, 5, 8])
def test_mix_blocks_pack_and_adjoint(m):
    """The blocks a | b of the entry points: packed, they are
    ``pack_mix_weight`` (so the JAX package's), bit for bit; the adjoint's
    blocks pack to the packed matrix transposed per mode; and
    ``_blocks_grad`` is the gradient of the packing."""
    w = torch.from_numpy(_weight(np.random.default_rng(m), 4, 3, 8))
    wab = tmix.mix_blocks(w, m)
    assert wab.shape == (m, 2, 4, 3)
    wpk = tmix.pack_mix_weight(w, m)
    assert torch.equal(tmix.pack_blocks(wab), wpk)
    assert torch.equal(tmix.pack_blocks(tmix.adjoint_blocks(wab)),
                       wpk.transpose(1, 2))
    leaf = wab.clone().requires_grad_()
    d = torch.from_numpy(
        np.random.default_rng(m + 1).standard_normal((m, 8, 6))
        .astype(np.float32))
    tmix.pack_blocks(leaf).backward(d)
    assert torch.equal(tmix._blocks_grad(d), leaf.grad)


@pytest.mark.parametrize("adjoint", [False, True])
def test_axis_pass_refuses_a_packed_matrix(adjoint):
    """The entry points take the weight's blocks (m, 2, C, O), never a
    packed (m, 2C, 2O) matrix, on the CPU as on the card: the bf16 kernel
    makes each mode's -b itself, so a packed matrix of another form than
    [[a, b], [-b, a]] would give it other results than the plain version."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((1, 4, 8, 4)).astype(np.float32))
    wpk = tmix.pack_mix_weight(torch.from_numpy(_weight(rng, 4, 4, 3)), 3)
    run = tmix.spectral_axis_adjoint if adjoint else tmix.spectral_axis_pass
    with pytest.raises(ValueError, match="blocks"):
        run(x, wpk, 2, "ortho", torch.float32)


# -- the f32 kernel's operands ------------------------------------------


def _plain_pass_f32_operands(x, f2p, i2p, wk, n, m, c, o):
    """The f32 kernel's pass, written plainly on its own padded operands:
    x (R, n, C) zero-padded to f2p's points and C8 channels, the forward
    product over every padded mode row, the mix of each mode's padded
    blocks a | b as the complex product (re = zr a - zi b, im = zr b + zi a)
    over z_k, the inverse over every padded mode row and point, cropped to
    (R, n, O)."""
    n1, sr = f2p.shape
    c8, o8 = wk.shape[2], wk.shape[3]
    xp = torch.zeros((x.shape[0], n1, c8))
    xp[:, :n, :c] = x
    z = torch.einsum("rwc,wj->rjc", xp, f2p)
    mk = torch.zeros((x.shape[0], sr, o8))
    for k in range(m):
        zr, zi, a, b = z[:, k], z[:, m + k], wk[k, 0], wk[k, 1]
        mk[:, k] = zr @ a - zi @ b
        mk[:, m + k] = zr @ b + zi @ a
    return torch.einsum("rjo,jw->rwo", mk, i2p)[:, :n, :o]


# (n, n_modes, C, O): ragged shapes of the f32 kernel's tiles, and wider
# channels (tiles of 2 rows, and of 1)
F32_CASES = [(40, 17, 24, 40), (32, 17, 24, 40), (15, 8, 5, 3), (16, 12, 4, 3),
             (16, 8, 96, 128), (12, 5, 200, 136)]


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("n,n_modes", [(256, 64), (64, 64), (40, 17), (15, 8)])
def test_kernel_factors_f32_pad_to_whole_tiles(n, n_modes, adjoint):
    """The f32 kernel reads f2 (n, 2m) padded to (n rounded up to 32, 2m
    rounded up to 128) and i2 (2m, n) padded to (2m rounded up to 128, n
    rounded up to 128): the factors bit for bit, zeros around them,
    contiguous f32, made once per shape and direction."""
    m = min(n_modes, n // 2 + 1)
    cpu = torch.device("cpu")
    f2, i2 = (tmix.adjoint_factors if adjoint else tmix.packed_factors)(
        n, m, "ortho", cpu)
    f2p, i2p = tmix.kernel_factors_f32(n, m, "ortho", cpu, adjoint)
    sr = -(-2 * m // 128) * 128
    assert f2p.shape == (-(-n // 32) * 32, sr)
    assert i2p.shape == (sr, -(-n // 128) * 128)
    for padded, mat in ((f2p, f2), (i2p, i2)):
        rows, cols = mat.shape
        assert padded.dtype == torch.float32 and padded.is_contiguous()
        assert torch.equal(padded[:rows, :cols], mat)
        assert not padded[rows:].any() and not padded[:, cols:].any()
    again = tmix.kernel_factors_f32(n, m, "ortho", cpu, adjoint)
    assert again[0] is f2p and again[1] is i2p


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("c,o", [(4, 3), (24, 40), (64, 64), (5, 64),
                                 (96, 128), (200, 136)])
def test_kernel_weight_f32_pads_each_mode(c, o, transpose):
    """The f32 kernel reads each mode's blocks a | b as (2, C8, O8) f32,
    zeros in the padding; for the adjoint the blocks a^T | -b^T."""
    rng = np.random.default_rng(c * o + 1)
    wab = tmix.mix_blocks(torch.from_numpy(_weight(rng, c, o, 7)), 5)
    w = tmix.adjoint_blocks(wab) if transpose else wab
    ci, co = (o, c) if transpose else (c, o)
    wk = tmix.kernel_weight_f32(w)
    assert wk.dtype == torch.float32 and wk.is_contiguous()
    assert wk.shape == (5, 2, -(-ci // 8) * 8, -(-co // 8) * 8)
    assert torch.equal(wk[:, :, :ci, :co], w)
    assert not wk[:, :, ci:].any() and not wk[:, :, :, co:].any()


@pytest.mark.parametrize("n,n_modes,c,o", F32_CASES, ids=_ids(F32_CASES))
def test_plain_pass_from_f32_kernel_operands_matches_jax(n, n_modes, c, o):
    """The pass computed plainly from the f32 kernel's own padded operands
    against the JAX package's f32-exact kernel (``truncated_spectral_mix_1d``
    in interpret mode), at ragged shapes: the padding adds nothing."""
    rng = np.random.default_rng(n * 31 + c)
    x = rng.standard_normal((5, n, c)).astype(np.float32)
    w = _weight(rng, c, o, n_modes)
    m = min(n_modes, n // 2 + 1)
    f2p, i2p = tmix.kernel_factors_f32(n, m, "ortho", torch.device("cpu"))
    wk = tmix.kernel_weight_f32(tmix.mix_blocks(torch.from_numpy(w), m))
    got = _plain_pass_f32_operands(torch.from_numpy(x), f2p, i2p, wk, n, m,
                                   c, o)
    want = np.asarray(jmix.truncated_spectral_mix_1d(
        jnp.asarray(x), jnp.asarray(w), n_modes, interpret=True))
    assert got.shape == (5, n, o)
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("m,c,o,fits", [
    (65, 64, 64, False), (64, 264, 64, False), (64, 64, 257, False),
    (8, 4, 3, True), (64, 64, 64, True), (64, 72, 64, True),
    (64, 128, 121, True), (64, 256, 249, True)])
def test_f32_kernel_shape_limits(m, c, o, fits):
    """The f32 kernel's tile holds up to 256 channels in and out (after
    padding to 8; 4 rows a tile up to 64, 2 up to 128, 1 up to 256) and 64
    modes; a launch of more is refused before it is made (the chunk plan
    keeps every launch within them), and the rest let through."""
    if fits:
        tmix._check_f32_shape(m, c, o)
    else:
        with pytest.raises(ValueError, match="at most"):
            tmix._check_f32_shape(m, c, o)


# -- the bf16 pass's wide shapes: the staged route ------------------------


@pytest.mark.parametrize("c", [64, 104, 128, 256])
def test_bf16_route_from_shape(c):
    """Every bf16 pass runs on the staged route (three tensor-core products
    through device memory) at any width, and every f32 pass on the
    CUDA-core kernel: the launcher decides from the shape alone, and a bf16
    shape past the staged route's grid (more than 65,535 modes) raises
    before any launch (chip_smoke.py holds the mirror to the library)."""
    assert tmix.staged_fits(256, 64, c, c)
    assert tmix.spectral_route(torch.bfloat16, 256, 64, c, c) == "staged"
    assert tmix.spectral_route(torch.float32, 256, 64, c, c) == "cuda_cores"
    assert not tmix.staged_fits(2 ** 17, 65536, c, c)
    with pytest.raises(ValueError, match="65535 modes"):
        tmix.spectral_route(torch.bfloat16, 2 ** 17, 65536, c, c)


def _chunked_f32_pass(x, f2, i2, wab, plan):
    """The f32 pass evaluated chunk by chunk as the launcher launches the
    f32 kernel over ``plan``: each chunk the plain f32 pass on its modes'
    factors, its input channels and its blocks, added into its slice of
    the output."""
    out = torch.zeros((*x.shape[:2], wab.shape[3]))
    for k0, k1, c0, c1, o0, o1 in plan:
        f2c, i2c = tmix.mode_factors(f2, i2, k0, k1)
        out[..., o0:o1] += tmix.spectral_pass_reference(
            x[..., c0:c1], f2c, i2c,
            tmix.pack_blocks(wab[k0:k1, :, c0:c1, o0:o1]), torch.float32)
    return out


@pytest.mark.parametrize("cd", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,c", [(80, 128), (64, 264)])
def test_shapes_beyond_both_kernels_raise(cd, m, c):
    """m = 80 (spectra too large for a block's shared memory) and 264
    channels (more than a tile's 256 columns) fit no fused kernel, which
    once made the launcher raise; now bf16 takes the staged route and f32
    the f32 kernel in chunks (2 of modes at m = 80, 2 x 2 of channels at
    264), and the route's plain version on its own operands agrees with
    the plain pass at n = 256: the staged stages within relative L2 1e-2
    (bf16 rounding flips only), the chunks within 1e-4 (f32 sums in
    another order)."""
    n = 256
    rng = np.random.default_rng(m + c)
    cpu = torch.device("cpu")
    x = torch.from_numpy(rng.standard_normal((2, n, c)).astype(np.float32))
    wab = tmix.mix_blocks(torch.from_numpy(_weight(rng, c, c, m)), m)
    f2, i2 = tmix.packed_factors(n, m, "ortho", cpu)
    want = tmix.spectral_pass_reference(x, f2, i2, tmix.pack_blocks(wab), cd)
    if cd == torch.bfloat16:
        assert tmix.spectral_route(cd, n, m, c, c) == "staged"
        a1, a3 = tmix.staged_factors(n, m, "ortho", cpu)
        got = tmix.staged_pass_plain(x, a1, a3, tmix.staged_weight(wab), m, c)
        tol = 1e-2
    else:
        assert tmix.spectral_route(cd, n, m, c, c) == "cuda_cores"
        plan = tmix.f32_chunk_plan(m, c, c)
        assert len(plan) == (2 if m == 80 else 4)
        got = _chunked_f32_pass(x, f2, i2, wab, plan)
        tol = 1e-4
    assert got.shape == want.shape
    rel = float(torch.linalg.vector_norm(got.float() - want.float())
                / torch.linalg.vector_norm(want.float()))
    assert rel <= tol


def test_spectral_pass_bf16_reference_wide_matches_jax():
    """The plain bf16 pass at C = O = 128, which the wide route is held to
    on the card, against the JAX package's pallas2 kernel in bf16
    (interpret mode) at n = 16, m = 6, 3 rows: both round x, the factors,
    the weight, the spectra and the mixed spectra to bf16 at the same
    points, so they differ by rounding flips only (bound: relative L2
    2e-2, as the other bf16 cases)."""
    rng = np.random.default_rng(128)
    n, n_modes, c = 16, 6, 128
    x = rng.standard_normal((3, n, c)).astype(np.float32)
    w = _weight(rng, c, c, n_modes) * c ** -0.5
    want = np.asarray(jmix2.packed_spectral_mix_1d(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w), n_modes,
        interpret=True, compute_dtype=jnp.bfloat16).astype(jnp.float32))
    m = min(n_modes, n // 2 + 1)
    f2, i2 = tmix.packed_factors(n, m, "ortho", torch.device("cpu"))
    got = tmix.spectral_pass_reference(
        torch.from_numpy(x).bfloat16(), f2, i2,
        tmix.pack_mix_weight(torch.from_numpy(w), m), torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (3, n, c)
    rel = np.linalg.norm(got.float().numpy() - want) / np.linalg.norm(want)
    assert rel <= 2e-2


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# (n, n_modes, C, O) of the staged route: m > 64, C = O = 136, 264 -> 200
# (past a fused tile's 256 channels), and ragged shapes of the narrow
# passes (n = 32 with m = 17; n = 40 with 24 -> 40 channels)
STAGED_CASES = [(160, 72, 16, 24), (16, 6, 136, 136), (12, 5, 264, 200),
                (32, 17, 64, 64), (40, 17, 24, 40)]


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("n,n_modes,c,o", STAGED_CASES,
                         ids=_ids(STAGED_CASES))
def test_staged_plain_matches_jax(n, n_modes, c, o, adjoint):
    """The staged route's three plain stages, composed on its own operands
    (``staged_factors``, ``staged_weight``), against the JAX package's
    pallas2 kernel in bf16 (interpret mode; the adjoint through its
    jax.vjp, which runs the kernel on the transposed factors and weight)
    within relative L2 2e-2, and against the plain bf16 pass within 1e-2:
    all three round x, the spectra and the mixed spectra to bf16 at the
    same points, so they differ by rounding flips only."""
    rng = np.random.default_rng(n * 3 + c)
    w = _weight(rng, c, o, n_modes) * c ** -0.5
    cin, cout = (o, c) if adjoint else (c, o)
    x = rng.standard_normal((3, n, cin)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)

    def op(a):
        return jmix2.packed_spectral_mix_1d(a, jnp.asarray(w), n_modes,
                                            interpret=True,
                                            compute_dtype=jnp.bfloat16)
    if adjoint:
        zeros = jnp.zeros((3, n, c), jnp.bfloat16)
        want = jax.vjp(op, zeros)[1](xb)[0]
    else:
        want = op(xb)
    want = np.asarray(want.astype(jnp.float32))
    m = min(n_modes, n // 2 + 1)
    cpu = torch.device("cpu")
    wab = tmix.mix_blocks(torch.from_numpy(w), m)
    blocks = tmix.adjoint_blocks(wab) if adjoint else wab
    a1, a3 = tmix.staged_factors(n, m, "ortho", cpu, adjoint)
    xt = torch.from_numpy(x).bfloat16()
    got = tmix.staged_pass_plain(xt, a1, a3, tmix.staged_weight(blocks), m,
                                 cout)
    assert got.dtype == torch.bfloat16 and got.shape == (3, n, cout)
    assert _rel(got.float().numpy(), want) <= 2e-2
    f2, i2 = (tmix.adjoint_factors if adjoint else tmix.packed_factors)(
        n, m, "ortho", cpu)
    plain = tmix.spectral_pass_reference(xt, f2, i2, tmix.pack_blocks(blocks),
                                         torch.bfloat16)
    assert _rel(got.float().numpy(), plain.float().numpy()) <= 1e-2


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("n,n_modes", [(256, 64), (160, 72), (64, 64),
                                       (40, 17), (32, 17), (15, 8)])
def test_staged_factors_pad_to_whole_tiles(n, n_modes, adjoint):
    """The staged route reads a1 = f2^T (2m, n) padded to (2m rounded up to
    128, n rounded up to 64) and a3 = i2^T (n, 2m) padded to (n rounded up
    to 128, 2m rounded up to 64): the factors in bf16 bit for bit, zeros
    around them, contiguous, made once per shape and direction."""
    m = min(n_modes, n // 2 + 1)
    cpu = torch.device("cpu")
    f2, i2 = (tmix.adjoint_factors if adjoint else tmix.packed_factors)(
        n, m, "ortho", cpu)
    a1, a3 = tmix.staged_factors(n, m, "ortho", cpu, adjoint)
    assert a1.shape == (-(-2 * m // 128) * 128, -(-n // 64) * 64)
    assert a3.shape == (-(-n // 128) * 128, -(-2 * m // 64) * 64)
    for padded, mat in ((a1, f2.t()), (a3, i2.t())):
        rows, cols = mat.shape
        assert padded.dtype == torch.bfloat16 and padded.is_contiguous()
        assert torch.equal(padded[:rows, :cols], mat.to(torch.bfloat16))
        assert not padded[rows:].any() and not padded[:, cols:].any()
    again = tmix.staged_factors(n, m, "ortho", cpu, adjoint)
    assert again[0] is a1 and again[1] is a3


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("c,o", [(4, 3), (24, 40), (64, 64), (40, 128),
                                 (136, 136), (264, 200)])
def test_staged_weight_pads_each_mode(c, o, adjoint):
    """The staged route reads each mode's blocks a | b as (2, C8, O8) in
    bf16, zeros in the padding (for the adjoint the blocks a^T | -b^T),
    and its mix multiplies by their packed form [[a, b], [-b, a]], which
    is the pass's packed matrix with the padding's zero rows and columns
    between the halves."""
    rng = np.random.default_rng(c * o + 3)
    wab = tmix.mix_blocks(torch.from_numpy(_weight(rng, c, o, 7)), 5)
    w = tmix.adjoint_blocks(wab) if adjoint else wab
    ci, co = (o, c) if adjoint else (c, o)
    c8, o8 = -(-ci // 8) * 8, -(-co // 8) * 8
    wst = tmix.staged_weight(w)
    assert wst.dtype == torch.bfloat16 and wst.is_contiguous()
    assert wst.shape == (5, 2, c8, o8)
    assert torch.equal(wst[:, :, :ci, :co], w.to(torch.bfloat16))
    assert not wst[:, :, ci:].any() and not wst[:, :, :, co:].any()
    packed = tmix.pack_blocks(wst.float()).view(5, 2, c8, 2, o8)
    want = tmix.pack_blocks(w).view(5, 2, ci, 2, co).to(torch.bfloat16)
    assert torch.equal(packed[:, :, :ci, :, :co], want.float())


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("n,m,c,o", [(40, 17, 24, 40), (32, 17, 64, 64),
                                     (15, 8, 5, 3), (256, 64, 8, 16)])
def test_plain_pass_from_staged_operands(n, m, c, o, adjoint):
    """The plain pass computed from the staged route's operands, unpacked
    (the factors from a1 and a3, the packed weight from each mode's padded
    blocks), equals the plain pass on the factors and weight it was
    given, bit for bit (both round every operand to bf16), at ragged
    shapes (n = 40, m = 17, 24 -> 40 channels, the adjoint 40 -> 24; n =
    32; 5 -> 3 channels) and at the train shape's n = 256, m = 64."""
    rng = np.random.default_rng(19 + n + c)
    cpu = torch.device("cpu")
    wab = tmix.mix_blocks(torch.from_numpy(_weight(rng, c, o, m)), m)
    if adjoint:
        f2, i2 = tmix.adjoint_factors(n, m, "ortho", cpu)
        w, cin, cout = tmix.adjoint_blocks(wab), o, c
    else:
        f2, i2 = tmix.packed_factors(n, m, "ortho", cpu)
        w, cin, cout = wab, c, o
    x = torch.from_numpy(rng.standard_normal((3, n, cin)).astype(np.float32))
    a1, a3 = tmix.staged_factors(n, m, "ortho", cpu, adjoint)
    wu = tmix.pack_blocks(tmix.staged_weight(w)[:, :, :cin, :cout].float())
    got = tmix.spectral_pass_reference(x, a1[:2 * m, :n].t(),
                                       a3[:n, :2 * m].t(), wu, torch.bfloat16)
    want = tmix.spectral_pass_reference(x, f2, i2, tmix.pack_blocks(w),
                                        torch.bfloat16)
    assert got.shape == (3, n, cout)
    assert torch.equal(got, want)


# -- the f32 pass beyond one launch: the chunk plan -----------------------


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("n,n_modes,c,o,chunks", [
    (160, 80, 8, 12, [(0, 64, 0, 8, 0, 12), (64, 80, 0, 8, 0, 12)]),
    (12, 5, 264, 72, [(0, 5, 0, 256, 0, 72), (0, 5, 256, 264, 0, 72)])])
def test_f32_chunk_plan_matches_jax(n, n_modes, c, o, chunks, adjoint):
    """An f32 pass beyond one launch of the f32 kernel (m = 80 modes; 264
    input channels) runs as its launches over chunks of at most 64 modes
    and 256 channels in a fixed order (asserted, with their count; the
    adjoint's plan swaps C and O); evaluated chunk by chunk by the plain
    f32 pass, each chunk on its modes' factors, it matches the JAX
    package's f32-exact kernel (interpret mode; the adjoint through its
    jax.vjp) within relative L2 1e-4."""
    rng = np.random.default_rng(n + c)
    w = _weight(rng, c, o, n_modes)
    cin, cout = (o, c) if adjoint else (c, o)
    x = rng.standard_normal((3, n, cin)).astype(np.float32)

    def op(a):
        return jmix.truncated_spectral_mix_1d(a, jnp.asarray(w), n_modes,
                                              interpret=True)
    if adjoint:
        want = jax.vjp(op, jnp.zeros((3, n, c)))[1](jnp.asarray(x))[0]
    else:
        want = op(jnp.asarray(x))
    m = min(n_modes, n // 2 + 1)
    plan = tmix.f32_chunk_plan(m, cin, cout)
    if adjoint:
        chunks = [(k0, k1, o0, o1, c0, c1)
                  for k0, k1, c0, c1, o0, o1 in chunks]
        chunks.sort(key=lambda t: (t[4], t[0], t[2]))
    assert plan == chunks
    cpu = torch.device("cpu")
    wab = tmix.mix_blocks(torch.from_numpy(w), m)
    f2, i2 = (tmix.adjoint_factors if adjoint else tmix.packed_factors)(
        n, m, "ortho", cpu)
    got = _chunked_f32_pass(torch.from_numpy(x), f2, i2,
                            tmix.adjoint_blocks(wab) if adjoint else wab, plan)
    assert got.shape == (3, n, cout)
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-4


@pytest.mark.parametrize("adjoint", [False, True])
def test_kernel_factors_f32_of_a_mode_range(adjoint):
    """The f32 kernel's factors for modes 64 .. 79 of an 80-mode pass are
    those of ``mode_factors`` (f2's columns and i2's rows of those modes,
    both parts), zero-padded to its tiles: 2 x 16 packed modes padded to
    128."""
    n, m = 160, 80
    cpu = torch.device("cpu")
    f2, i2 = (tmix.adjoint_factors if adjoint else tmix.packed_factors)(
        n, m, "ortho", cpu)
    f2p, i2p = tmix.kernel_factors_f32(n, m, "ortho", cpu, adjoint, 64, 80)
    cols = list(range(64, 80)) + list(range(144, 160))
    assert f2p.shape == (160, 128) and i2p.shape == (128, 256)
    assert torch.equal(f2p[:n, :32], f2[:, cols])
    assert torch.equal(i2p[:32, :n], i2[cols])
    assert not f2p[:, 32:].any() and not i2p[32:].any()


# -- the bf16 weight gradient's kernels, written plainly -------------------

# (B, H, W, C, O, n_modes): ragged shapes of the weight gradient's kernels,
# n no multiple of 64, m odd along both axes (17 along W = 40 and 11 along
# H = 20; 7 along W = 15 and H = 24) and C, O no multiple of 8
WGRAD_CASES = [(2, 20, 40, 5, 3, 17), (1, 24, 15, 12, 20, 7),
               (1, 6, 40, 24, 40, 17)]


@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("b,h,w,c,o,n_modes", WGRAD_CASES,
                         ids=["-".join(map(str, k)) for k in WGRAD_CASES])
def test_weight_grad_staged_plain_matches_jax(b, h, w, c, o, n_modes, axis):
    """``weight_grad_staged_plain``, the bf16 weight gradient's kernels
    written plainly on their operands (the two padded a1 factors, rows read
    through the strides, spectra rounded to bf16, the per-mode product in
    f32), against ``spectral_weight_grad`` on the CPU (the plain torch
    products, the same rounding points: rounding flips only) and against
    jax.vjp of the JAX package's pallas2 kernel in bf16 (interpret mode)
    with respect to its weight, within relative L2 2e-2 as the other bf16
    comparisons with JAX. On the CPU no kernel runs."""
    rng = np.random.default_rng(b * h * w + c + o + axis)
    n = (h, w)[axis - 1]
    m = min(n_modes, n // 2 + 1)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    g = rng.standard_normal((b, h, w, o)).astype(np.float32)
    wt = _weight(rng, c, o, n_modes) * c ** -0.5
    cpu = torch.device("cpu")
    xt, gt = torch.from_numpy(x).bfloat16(), torch.from_numpy(g).bfloat16()
    a1x = tmix.staged_factors(n, m, "ortho", cpu)[0]
    a1g = tmix.staged_factors(n, m, "ortho", cpu, adjoint=True)[0]
    launches = tmix.wgrad_launches
    got = tmix.weight_grad_staged_plain(xt, gt, a1x, a1g, m, axis)
    plain = tmix.spectral_weight_grad(xt, gt, m, axis, "ortho",
                                      torch.bfloat16)
    assert tmix.wgrad_launches == launches
    assert got.dtype == plain.dtype == torch.float32
    assert got.shape == plain.shape == (m, 2, c, o)
    assert _rel(got.numpy(), plain.numpy()) <= 1e-3

    def rows(a):  # (R, n, channels) along the axis, as the JAX kernel takes
        a = a if axis == 2 else np.swapaxes(a, 1, 2)
        return jnp.asarray(a.reshape(-1, n, a.shape[3])).astype(jnp.bfloat16)

    def op(wj):
        return jmix2.packed_spectral_mix_1d(rows(x), wj, n_modes,
                                            interpret=True,
                                            compute_dtype=jnp.bfloat16)
    jdw = jax.vjp(op, jnp.asarray(wt))[1](rows(g))[0]
    want = tmix.mix_blocks(torch.from_numpy(np.array(jdw)), m)
    assert _rel(got.numpy(), want.numpy()) <= 2e-2


@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("view", ["pencil", "sliced_channels", "transposed"])
def test_weight_grad_staged_plain_reads_strided_views(view, axis):
    """``weight_grad_staged_plain`` reads x's rows along the axis through
    its strides, as the kernels read them in place: on a view (columns
    8..23 of a wider grid, 5 channels sliced from 8, or H and W swapped by
    a transpose) it gives the bits it gives on the view's contiguous
    copy."""
    gen = torch.Generator().manual_seed(axis)
    grid = torch.randn((2, 24, 32, 8), generator=gen).bfloat16()
    x = {"pencil": grid[:, :, 8:24], "sliced_channels": grid[..., 1:6],
         "transposed": grid.transpose(1, 2)}[view]
    assert not x.is_contiguous()
    g = torch.randn(tuple(x.shape[:3]) + (12,), generator=gen).bfloat16()
    n = x.shape[axis]
    m = min(7, n // 2 + 1)
    cpu = torch.device("cpu")
    a1x = tmix.staged_factors(n, m, "ortho", cpu)[0]
    a1g = tmix.staged_factors(n, m, "ortho", cpu, adjoint=True)[0]
    got = tmix.weight_grad_staged_plain(x, g, a1x, a1g, m, axis)
    want = tmix.weight_grad_staged_plain(x.contiguous(), g, a1x, a1g, m, axis)
    assert got.shape == (m, 2, x.shape[3], 12)
    assert torch.equal(got, want)
