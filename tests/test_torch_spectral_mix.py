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


# -- the bf16 kernel's operands -----------------------------------------


def _unfragment(v, rows, cols):
    """Inverse of the launcher's fragment order: (M16 * K64,) -> (M16, K64)."""
    mt, kt = -(-rows // 16), -(-cols // 64) * 4
    return (v.view(mt, kt, 8, 4, 2, 2, 2).permute(0, 5, 2, 1, 4, 3, 6)
            .reshape(mt * 16, kt * 16))


def _unpad_weight(wk, c, o):
    """The kernel's (m, 2, C8, O8) weight -> the packed (m, 2C, 2O)
    [[a, b], [-b, a]] it stands for, and its padding. Rows of a multiple of
    64 columns come with their 16-byte chunks swizzled (chunk q of row r at
    q ^ (r mod 8)), which undoes itself."""
    m, _, c8, o8 = wk.shape
    if o8 % 64 == 0:
        chunk = torch.arange(o8 // 8)[None, :] ^ (torch.arange(c8)[:, None] % 8)
        cols = (chunk[:, :, None] * 8 + torch.arange(8)).reshape(c8, o8)
        wk = wk.gather(3, cols.expand(m, 2, c8, o8))
    a, b = wk[:, 0, :c, :o], wk[:, 1, :c, :o]
    pad = torch.cat([wk[:, :, c:].reshape(-1), wk[:, :, :, o:].reshape(-1)])
    return torch.cat([torch.cat([a, b], 2), torch.cat([-b, a], 2)], 1), pad


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("n,n_modes", [(256, 64), (40, 17), (32, 17), (15, 8)])
def test_kernel_factors_pad_to_whole_fragments(n, n_modes, adjoint):
    """The bf16 kernel reads f2^T (2m, n) and i2^T (n, 2m) as A fragments,
    each zero-padded to whole 16 x 16 tiles (the contraction to a multiple
    of 64) in fragment order: unpacked,
    they are the factors in bf16, bit for bit, with zeros around them; and
    they are made once per shape."""
    m = min(n_modes, n // 2 + 1)
    cpu = torch.device("cpu")
    f2, i2 = (tmix.adjoint_factors if adjoint else tmix.packed_factors)(
        n, m, "ortho", cpu)
    a1, a3 = tmix.kernel_factors(n, m, "ortho", cpu, adjoint)
    assert a1.dtype == a3.dtype == torch.bfloat16
    for packed, mat in ((a1, f2.t()), (a3, i2.t())):
        rows, cols = mat.shape
        full = _unfragment(packed, rows, cols)
        assert full.shape == (-(-rows // 16) * 16, -(-cols // 64) * 64)
        assert torch.equal(full[:rows, :cols], mat.to(torch.bfloat16))
        assert not full[rows:].any() and not full[:, cols:].any()
    again = tmix.kernel_factors(n, m, "ortho", cpu, adjoint)
    assert again[0] is a1 and again[1] is a3


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("c,o", [(4, 3), (24, 40), (64, 64), (40, 128)])
def test_kernel_weight_pads_each_mode(c, o, transpose):
    """The bf16 kernel streams each mode's packed weight [[a, b], [-b, a]]
    as its first block row, (2, C8, O8): a and b padded to 8 channels with
    zeros; rebuilt, it is the packed weight in bf16, bit for bit. The
    adjoint packs the per-mode transpose, (2, O8, C8), from its blocks."""
    rng = np.random.default_rng(c * o)
    wab = tmix.mix_blocks(torch.from_numpy(_weight(rng, c, o, 7)), 5)
    w = tmix.adjoint_blocks(wab) if transpose else wab
    ci, co = (o, c) if transpose else (c, o)
    wk = tmix.kernel_weight(w)
    assert wk.dtype == torch.bfloat16 and wk.is_contiguous()
    assert wk.shape == (5, 2, -(-ci // 8) * 8, -(-co // 8) * 8)
    body, pad = _unpad_weight(wk, ci, co)
    wpk = tmix.pack_blocks(wab)
    assert torch.equal(body, (wpk.transpose(1, 2) if transpose else wpk)
                       .to(torch.bfloat16))
    assert not pad.any()


@pytest.mark.parametrize("adjoint", [False, True])
def test_plain_pass_from_kernel_operands(adjoint):
    """The plain pass computed from the bf16 kernel's operands, unpacked,
    equals the plain pass on the factors and weight it was given, bit for
    bit (both round every operand to bf16), at a ragged shape: n = 40,
    m = 17, 24 -> 40 channels (the adjoint 40 -> 24)."""
    rng = np.random.default_rng(17)
    n, m, c, o = 40, 17, 24, 40
    cpu = torch.device("cpu")
    wab = tmix.mix_blocks(torch.from_numpy(_weight(rng, c, o, m)), m)
    wpk = tmix.pack_blocks(wab)
    if adjoint:
        f2, i2 = tmix.adjoint_factors(n, m, "ortho", cpu)
        w, cin, cout = tmix.adjoint_blocks(wab), o, c
        wpk = wpk.transpose(1, 2)
    else:
        f2, i2 = tmix.packed_factors(n, m, "ortho", cpu)
        w, cin, cout = wab, c, o
    x = torch.from_numpy(rng.standard_normal((3, n, cin)).astype(np.float32))
    a1, a3 = tmix.kernel_factors(n, m, "ortho", cpu, adjoint)
    f2u = _unfragment(a1, 2 * m, n)[:2 * m, :n].t()
    i2u = _unfragment(a3, n, 2 * m)[:n, :2 * m].t()
    wu, _ = _unpad_weight(tmix.kernel_weight(w), cin, cout)
    got = tmix.spectral_pass_reference(x, f2u, i2u, wu, torch.bfloat16)
    want = tmix.spectral_pass_reference(x, f2, i2, wpk, torch.bfloat16)
    assert got.shape == (3, n, cout)
    assert torch.equal(got, want)


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
    modes; the launcher refuses more before any launch, and lets the rest
    through."""
    if fits:
        tmix._check_f32_shape(m, c, o)
    else:
        with pytest.raises(ValueError, match="at most"):
            tmix._check_f32_shape(m, c, o)


# -- the bf16 pass's wide shapes -----------------------------------------


@pytest.mark.parametrize("c,route", [(104, "mma"), (112, "cuda_cores"),
                                     (128, "cuda_cores"), (256, "cuda_cores")])
def test_bf16_route_from_shape(c, route):
    """At n = 256, m = 64 the bf16 tensor-core kernel's two ring stages of
    two weight modes fit beside a one-row tile's spectra up to C = O = 104;
    wider bf16 passes run on the CUDA-core kernel (the f32 one's, with the
    bf16 rounding points), as every f32 pass does. The launcher's mirror
    of the planner decides from the shape alone (chip_smoke.py holds it to
    the planner)."""
    assert tmix.mma_fits(256, 64, c, c) == (route == "mma")
    assert tmix.spectral_route(torch.bfloat16, 256, 64, c, c) == route
    assert tmix.spectral_route(torch.float32, 256, 64, c, c) == "cuda_cores"


@pytest.mark.parametrize("cd", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,c", [(80, 128), (64, 264)])
def test_shapes_beyond_both_kernels_raise(cd, m, c):
    """m = 80 (spectra too large for shared memory) and 264 channels (more
    than a tile's 256 columns) fit neither kernel: the launcher raises the
    CUDA-core kernel's ValueError before any launch, in both modes."""
    assert not tmix.mma_fits(256, m, c, c)
    with pytest.raises(ValueError, match="at most 256 channels and 64 modes"):
        tmix.spectral_route(cd, 256, m, c, c)
    x = torch.zeros((1, 1, 2 * m, c))
    wab = torch.zeros((m, 2, c, c))
    with pytest.raises(ValueError, match="at most 256 channels and 64 modes"):
        tmix._launch(x, wab, 2, "ortho", False, cd, None)


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


@pytest.mark.parametrize("adjoint", [False, True])
def test_wide_route_operands_are_the_bf16_values(adjoint):
    """The wide route's operands are the f32 kernel's packings of the bf16
    values: its factors (``kernel_factors_f32`` with ``bf16``) and each
    mode's blocks (``kernel_weight_f32`` with ``bf16``) equal the factors
    and the blocks rounded to bf16, bit for bit, zeros around them; and the
    pass computed plainly from them with the bf16 rounding points (x, the
    spectra and the mixed spectra rounded) is the plain bf16 pass up to
    the order of its f32 sums."""
    rng = np.random.default_rng(7)
    n, m, c, o = 40, 17, 128, 120
    cpu = torch.device("cpu")
    wab = tmix.mix_blocks(torch.from_numpy(_weight(rng, c, o, m)), m)
    f2, i2 = (tmix.adjoint_factors if adjoint else tmix.packed_factors)(
        n, m, "ortho", cpu)
    w = tmix.adjoint_blocks(wab) if adjoint else wab
    f2p, i2p = tmix.kernel_factors_f32(n, m, "ortho", cpu, adjoint, True)
    wk = tmix.kernel_weight_f32(w, True)
    bf = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    for padded, mat in ((f2p, f2), (i2p, i2)):
        rows, cols = mat.shape
        assert torch.equal(padded[:rows, :cols], bf(mat))
        assert not padded[rows:].any() and not padded[:, cols:].any()
    ci, co = w.shape[2], w.shape[3]
    assert torch.equal(wk[:, :, :ci, :co], bf(w))
    assert not wk[:, :, ci:].any() and not wk[:, :, :, co:].any()
    x = torch.from_numpy(rng.standard_normal((3, n, ci)).astype(np.float32))
    n1, sr = f2p.shape
    xp = torch.zeros((3, n1, wk.shape[2]))
    xp[:, :n, :ci] = bf(x)
    z = bf(torch.einsum("rwc,wj->rjc", xp, f2p))
    mk = torch.zeros((3, sr, wk.shape[3]))
    for k in range(m):
        zr, zi, a, b = z[:, k], z[:, m + k], wk[k, 0], wk[k, 1]
        mk[:, k] = zr @ a - zi @ b
        mk[:, m + k] = zr @ b + zi @ a
    got = torch.einsum("rjo,jw->rwo", bf(mk), i2p)[:, :n, :co]
    want = tmix.spectral_pass_reference(x, f2, i2, tmix.pack_blocks(w),
                                        torch.bfloat16).float()
    assert got.shape == want.shape
    rel = float(torch.linalg.vector_norm(got - want)
                / torch.linalg.vector_norm(want))
    assert rel <= 1e-2
