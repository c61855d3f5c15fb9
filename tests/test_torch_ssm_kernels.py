"""The port's SSM kernels on the CPU against the JAX package: K4 (the S4D
Vandermonde reduction, ``ops/kernels/vandermonde.py``) and K5 (the four
Cauchy sums and the DPLR kernel around them, ``ops/kernels/cauchy.py``)
through their plain versions, against the Pallas kernels in interpret
mode and against the ``jnp`` route (``ops.ssm``); the port's ``ops.ssm``
against the JAX module; the kernels' forward-only autograd nodes.

Tolerances, as relative L2 over the whole output: 1e-5 where both sides
run the same f32 formulation (only the transcendental functions' last
bits and the order of the sums differ, about 1e-6 measured); the JAX
tests' own elementwise bounds beside it where the formulations differ
(the Pallas route against ``ssm``: rtol 1e-3 / atol 1e-4 for K4 and
rtol 2e-4 / atol 2e-5 for K5, tests/test_pallas.py). The numpy
initializers are the same code, so they agree exactly.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from resolution_pde_tpu.ops import ssm as jssm  # noqa: E402
from resolution_pde_tpu.ops.pallas.cauchy import (  # noqa: E402
    cauchy_pallas as jax_cauchy_pallas,
    dplr_kernel_pallas as jax_dplr_kernel_pallas)
from resolution_pde_tpu.ops.pallas.vandermonde import (  # noqa: E402
    s4d_kernel_pallas as jax_s4d_kernel_pallas)
from resolution_pde_tpu_torch.ops import ssm  # noqa: E402
from resolution_pde_tpu_torch.ops.kernels import cauchy, vandermonde  # noqa: E402

SAME = 1e-5  # relative L2, same f32 formulation on both sides


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.complex128)
    want = np.asarray(want, np.complex128)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _s4d_inputs(rng, h, n, channels):
    A = (-(0.5 + rng.uniform(0, 1, (h, n)))
         + 1j * np.pi * rng.uniform(0, n, (h, n))).astype(np.complex64)
    shape = (h, n) if channels is None else (channels, h, n)
    C = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(np.complex64)
    log_dt = np.log(rng.uniform(1e-3, 1e-1, h)).astype(np.float32)
    return C, A, log_dt


@pytest.mark.parametrize("channels", [None, 3])
def test_vandermonde_matches_jax_pallas_and_zoh(rng, channels):
    h, n, L = 6, 8, 48
    C, A, log_dt = _s4d_inputs(rng, h, n, channels)
    got = vandermonde.s4d_kernel_pallas(t(C), t(A), t(log_dt), L).numpy()
    want = np.asarray(jax_s4d_kernel_pallas(
        jnp.asarray(C), jnp.asarray(A), jnp.asarray(log_dt), L,
        interpret=True))
    assert got.shape == want.shape == (((channels,) if channels else ())
                                       + (h, L))
    assert rel_l2(got, want) <= SAME
    zoh = np.asarray(jax.vmap(
        lambda c: jssm.s4d_kernel_zoh(c, jnp.asarray(A), jnp.asarray(log_dt),
                                      L))(jnp.asarray(C).reshape(-1, h, n)))
    np.testing.assert_allclose(got.reshape(zoh.shape), zoh, rtol=1e-3,
                               atol=1e-4)


def test_vandermonde_reference_ragged_rows_and_long_sequence(rng):
    """Rows and positions that fill no tile (18 rows, N 8, L 40) and
    Im(dtA) l up to thousands of radians, against numpy's sums of the same
    f32 terms."""
    rows, n, L = 18, 8, 40
    ar = -rng.uniform(1e-4, 0.05, (rows, n)).astype(np.float32)
    ai = rng.uniform(-100, 100, (rows, n)).astype(np.float32)
    cr, ci = (rng.standard_normal((2, rows, n)) * 0.3).astype(np.float32)
    got = vandermonde.vandermonde(t(ar), t(ai), t(cr), t(ci), L).numpy()
    ls = np.arange(L, dtype=np.float32)
    want = 2.0 * (np.einsum("rn,rnl->rl", cr.astype(np.float64),
                            np.exp(ar[..., None] * ls)
                            * np.cos(ai[..., None] * ls))
                  - np.einsum("rn,rnl->rl", ci.astype(np.float64),
                              np.exp(ar[..., None] * ls)
                              * np.sin(ai[..., None] * ls)))
    assert got.shape == (rows, L)
    assert rel_l2(got, want) <= SAME


def test_cauchy_matches_jax_pallas(rng):
    h, n, L = 5, 8, 36
    lam = (-(0.1 + rng.uniform(0, 1, (h, n)))
           + 1j * rng.standard_normal((h, n))).astype(np.complex64)
    v = (rng.standard_normal((4, h, n))
         + 1j * rng.standard_normal((4, h, n))).astype(np.complex64)
    g = (rng.standard_normal((h, L))
         + 1j * rng.standard_normal((h, L))).astype(np.complex64)
    got = cauchy.cauchy_pallas(t(v), t(g), t(lam)).numpy()
    want = np.asarray(jax_cauchy_pallas(jnp.asarray(v), jnp.asarray(g),
                                        jnp.asarray(lam), interpret=True))
    assert got.shape == (4, h, L) and got.dtype == np.complex64
    assert rel_l2(got, want) <= SAME
    naive = np.stack([ssm.cauchy(t(v[k, r]), t(g[r]), t(lam[r])).numpy()
                      for k in range(4) for r in range(h)]).reshape(4, h, L)
    np.testing.assert_allclose(got, naive, rtol=2e-4, atol=2e-5)


def _dplr_inputs(rng, h, n):
    lam0, p0, b0, _ = jssm.make_dplr_hippo(n)
    Lam, P, B = (np.broadcast_to(z, (h, n)).astype(np.complex64)
                 for z in (lam0, p0, b0))
    C = (rng.standard_normal((h, n))
         + 1j * rng.standard_normal((h, n))).astype(np.complex64)
    log_dt = np.log(rng.uniform(1e-3, 1e-1, h)).astype(np.float32)
    return Lam, P, B, C, log_dt


@pytest.mark.parametrize("L", [32, 40])
def test_dplr_kernel_pallas_matches_jax(rng, L):
    """The port's Pallas-route DPLR kernel against the JAX one (the same
    formulation) and against vmap(ssm.dplr_kernel) (dt folded into v and
    Lambda). L even puts a root at l = L/2, where 1 + omega is tiny."""
    h, n = 4, 8
    Lam, P, B, C, log_dt = _dplr_inputs(rng, h, n)
    args = [jnp.asarray(a) for a in (Lam, P, B, C, log_dt)]
    got = cauchy.dplr_kernel_pallas(*(t(a) for a in (Lam, P, B, C, log_dt)),
                                    L).numpy()
    want = np.asarray(jax_dplr_kernel_pallas(*args, L, interpret=True))
    assert got.shape == (h, L) and np.isfinite(got).all()
    assert rel_l2(got, want) <= SAME
    ref = np.asarray(jax.vmap(
        lambda la, p, b, c, d: jssm.dplr_kernel(la, p, b, c, d, L))(*args))
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)


def test_roots_of_unity_keep_the_half_root_off_zero():
    """omega from the f32 angle, as JAX forms it: 1 + omega at l = L/2 is
    i * sin(f32 pi), so g and g^2 stay finite at dt = 1e-3."""
    L = 512
    got = ssm.roots_of_unity(L).numpy()
    want = np.asarray(jssm.cexp(-2j * jnp.pi * jnp.arange(L) / L))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    half = 1.0 + got[L // 2]
    assert half.real == 0.0 and 8e-8 < half.imag < 9e-8
    step = 1e-3
    g = (2.0 / step) * ((1.0 - got[L // 2]) / half)
    assert np.isfinite(np.float32(abs(g)) ** 2)


@pytest.mark.parametrize("disc", ["zoh", "bilinear", "dss"])
def test_s4d_kernels_match_jax(rng, disc):
    h, n, L = 6, 8, 48
    C, A, log_dt = _s4d_inputs(rng, h, n, 3)
    A[0, :2] = A[0, :2].imag * 1j + 0.3  # positive real parts for dss
    got = ssm.S4D_KERNELS[disc](t(C), t(A), t(log_dt), L).numpy()
    want = np.asarray(jax.vmap(lambda c: jssm.S4D_KERNELS[disc](
        c, jnp.asarray(A), jnp.asarray(log_dt), L))(jnp.asarray(C)))
    assert rel_l2(got, want) <= SAME


@pytest.mark.parametrize("rank", [1, 2])
def test_dplr_kernel_matches_jax(rng, rank):
    h, n, L = 4, 8, 32
    Lam, P, B, C, log_dt = _dplr_inputs(rng, h, n)
    if rank > 1:
        P = (rng.standard_normal((h, rank, n))
             + 1j * rng.standard_normal((h, rank, n))).astype(np.complex64)
    dt = np.exp(log_dt)[:, None] * np.ones((1, n), np.float32)
    dt[:, n // 2:] *= 1.5  # one step per state
    dt = dt.astype(np.float32)
    got = ssm.dplr_kernel(t(Lam), t(P), t(B), t(C), None, L, dt=t(dt))
    want = jax.vmap(lambda la, p, b, c, d: jssm.dplr_kernel(
        la, p, b, c, None, L, dt=d))(*(jnp.asarray(a)
                                       for a in (Lam, P, B, C, dt)))
    assert rel_l2(got.numpy(), want) <= SAME


def test_fft_causal_conv_and_complex_helpers_match_jax(rng):
    x = rng.standard_normal((3, 4, 20)).astype(np.float32)
    k = rng.standard_normal((4, 20)).astype(np.float32)
    got = ssm.fft_causal_conv(t(x), t(k)).numpy()
    want = np.asarray(jssm.fft_causal_conv(jnp.asarray(x), jnp.asarray(k)))
    assert rel_l2(got, want) <= SAME
    z = (rng.standard_normal(16) * 2 + 1j * rng.standard_normal(16) * 9
         ).astype(np.complex64)
    for port, ref in ((ssm.cexp, jssm.cexp), (ssm.clog, jssm.clog)):
        assert rel_l2(port(t(z)).numpy(), ref(jnp.asarray(z))) <= SAME


@pytest.mark.parametrize("kind", ["none", "exp", "relu", "sigmoid",
                                  "softplus"])
def test_param_transforms_match_jax(rng, kind):
    x = (rng.standard_normal(32) * 3).astype(np.float32)
    got = ssm.param_transform(t(x), kind).numpy()
    np.testing.assert_allclose(got, jssm.param_transform(jnp.asarray(x),
                                                         kind),
                               rtol=1e-6, atol=1e-7)
    pos = np.abs(x) / 4 + 1e-3
    if kind == "sigmoid":
        pos = np.minimum(pos, 0.9)
    np.testing.assert_allclose(
        ssm.inv_param_transform_tensor(t(pos), kind).numpy(),
        jssm.inv_param_transform_jnp(jnp.asarray(pos), kind),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ssm.inv_param_transform(pos, kind),
                                  jssm.inv_param_transform(pos, kind))


@pytest.mark.parametrize("measure,rank", [("legs", 1), ("legt", 2),
                                          ("fourier", 1), ("legs", 3)])
def test_nplr_inits_equal_jax(measure, rank):
    for got, want in zip(ssm.nplr_init(measure, 8, rank),
                         jssm.nplr_init(measure, 8, rank)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(ssm.hippo_transition(measure, 8),
                         jssm.hippo_transition(measure, 8)):
        np.testing.assert_array_equal(got, want)


def test_diag_and_legs_inits_equal_jax():
    for got, want in zip(ssm.make_dplr_hippo(16), jssm.make_dplr_hippo(16)):
        np.testing.assert_array_equal(got, want)
    for init in ssm.DIAG_INITS:
        for got, want in zip(ssm.diag_ssm_init(init, 8),
                             jssm.diag_ssm_init(init, 8)):
            np.testing.assert_array_equal(got, want)
    for got, want in zip(ssm.s4d_lin_init(4, 8), jssm.s4d_lin_init(4, 8)):
        np.testing.assert_array_equal(got, want)
    assert ssm.MEASURE_COMBINATIONS == jssm.MEASURE_COMBINATIONS


def test_kernels_are_forward_only_and_launch_nothing_on_cpu(rng):
    """Backward through either kernel raises instead of returning a
    detached or zero gradient; the CPU runs the plain versions and
    launches nothing."""
    start = (vandermonde.launches, cauchy.launches)
    planes = [torch.randn(6, 4, requires_grad=True) for _ in range(4)]
    out = vandermonde.vandermonde(*planes, 10)
    assert out.grad_fn is not None
    with pytest.raises(NotImplementedError, match="forward-only"):
        out.sum().backward()
    v = [torch.randn(4, 3, 5, requires_grad=True) for _ in range(2)]
    lam = [torch.randn(3, 5) for _ in range(2)]
    g = [torch.randn(3, 7) for _ in range(2)]
    outr, outi = cauchy.cauchy_sums(*v, *lam, *g)
    with pytest.raises(NotImplementedError, match="forward-only"):
        (outr.sum() + outi.sum()).backward()
    assert (vandermonde.launches, cauchy.launches) == start == (0, 0)


def test_kernel_wrappers_check_devices_and_shapes():
    meta = [torch.zeros(3, 4, device="meta") for _ in range(4)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        vandermonde.vandermonde(*meta, 8)
    with pytest.raises(ValueError, match="cpu or cuda"):
        cauchy.cauchy_sums(torch.zeros(4, 3, 5, device="meta"),
                           torch.zeros(4, 3, 5, device="meta"), *meta[:2],
                           *meta[2:])
    with pytest.raises(ValueError, match=r"\(R, N\)"):
        vandermonde.vandermonde(torch.zeros(3, 4), torch.zeros(3, 5),
                                torch.zeros(3, 4), torch.zeros(3, 4), 8)
    with pytest.raises(ValueError, match="planes"):
        cauchy.cauchy_sums(torch.zeros(3, 3, 5), torch.zeros(3, 3, 5),
                           torch.zeros(3, 5), torch.zeros(3, 5),
                           torch.zeros(3, 7), torch.zeros(3, 7))


def test_fused_entries_read_rows_mod_h_as_jax_does(rng):
    """The fused entries' plain versions (what the kernels' fused entries
    are held to on the card) at 2 channels x 9 features and a ragged L 40,
    each row reading its feature's parameters at row mod H: K4's against
    the JAX s4d_kernel_pallas and against the plane entry on the same
    operands; K5's against the JAX dplr_kernel_pallas on the parameters
    tiled to the rows, and the values at the roots against the four sums
    combined by hand. Relative L2 1e-5: the same f32 formulation on both
    sides."""
    ch, h, n, L = 2, 9, 8, 40
    C, A, log_dt = _s4d_inputs(rng, h, n, ch)
    got = vandermonde.s4d_kernel_pallas(t(C), t(A), t(log_dt), L).numpy()
    want = np.asarray(jax_s4d_kernel_pallas(
        jnp.asarray(C), jnp.asarray(A), jnp.asarray(log_dt), L,
        interpret=True))
    assert got.shape == (ch, h, L)
    assert rel_l2(got, want) <= SAME
    planes = vandermonde.s4d_operands(t(C), t(A), t(log_dt))
    np.testing.assert_array_equal(
        got.reshape(ch * h, L), vandermonde.vandermonde(*planes, L).numpy())

    Lam, P, B, _, log_dt = _dplr_inputs(rng, h, n)
    Ct = (rng.standard_normal((ch * h, n))
          + 1j * rng.standard_normal((ch * h, n))).astype(np.complex64)
    args = [t(a) for a in (Lam, P, B, Ct, log_dt)]
    got = cauchy.dplr_kernel_pallas(*args, L).numpy()
    tiled = [jnp.asarray(np.concatenate([a] * ch)) for a in
             (Lam, P, B)] + [jnp.asarray(Ct),
                             jnp.asarray(np.concatenate([log_dt] * ch))]
    want = np.asarray(jax_dplr_kernel_pallas(*tiled, L, interpret=True))
    assert got.shape == (ch * h, L) and np.isfinite(got).all()
    assert rel_l2(got, want) <= SAME
    v, g, c = cauchy.dplr_operands(*args, L)
    k00, k01, k10, k11 = cauchy.cauchy_pallas(v, g, args[0].repeat(ch, 1))
    by_hand = c * (k00 - k01 * (1.0 / (1.0 + k11)) * k10)
    at_roots = cauchy.dplr_at_roots(*args, L)
    assert at_roots.dtype == torch.complex64
    np.testing.assert_array_equal(at_roots.numpy(), by_hand.numpy())


def test_fused_entries_are_forward_only_and_check_shapes():
    """A backward through either fused entry raises, as through the plane
    entries; the CPU launches nothing; shapes the kernels do not take and
    devices they do not run on are refused with a ValueError."""
    start = (vandermonde.launches, cauchy.launches)
    c_vec = torch.randn(2, 3, 4, 2, requires_grad=True)
    a = torch.complex(-torch.rand(3, 4) - 0.5, torch.randn(3, 4))
    out = vandermonde.s4d_kernel_pallas(torch.view_as_complex(c_vec), a,
                                        torch.full((3,), -3.0), 10)
    assert out.shape == (2, 3, 10) and out.grad_fn is not None
    with pytest.raises(NotImplementedError, match="forward-only"):
        out.sum().backward()
    lam = torch.complex(-torch.rand(3, 4) - 0.1, torch.randn(3, 4))
    out = cauchy.dplr_kernel_pallas(lam, lam, lam,
                                    torch.view_as_complex(c_vec).reshape(6, 4),
                                    torch.full((3,), -3.0), 10)
    assert out.shape == (6, 10)
    with pytest.raises(NotImplementedError, match="forward-only"):
        out.sum().backward()
    assert (vandermonde.launches, cauchy.launches) == start == (0, 0)
    with pytest.raises(ValueError, match=r"A \(H, N\)"):
        vandermonde.s4d_kernel_pallas(torch.zeros(2, 3, 5, dtype=a.dtype), a,
                                      torch.zeros(3), 10)
    with pytest.raises(ValueError, match="channels x H"):
        cauchy.dplr_at_roots(lam, lam, lam, torch.zeros(5, 4, dtype=a.dtype),
                             torch.zeros(3), 10)
    with pytest.raises(ValueError, match="cpu or cuda"):
        cauchy.dplr_at_roots(*(torch.zeros(3, 4, dtype=a.dtype,
                                           device="meta"),) * 4,
                             torch.zeros(3, device="meta"), 10)


def test_at_roots_limit_separates_rounding_from_a_fault(rng):
    """The elementwise hold on the values at the roots: evaluations that
    differ from the plain version only in rounding (the states summed in
    reverse order; the sums in float64) depart from it by at most
    AT_ROOTS_LIMIT, in units of 2^-24 times the rounding's scale, beyond
    rtol 2e-4 / atol 2e-5; one state's C~ off by 2^-10 departs by far
    more. HiPPO-LegS at N = 64, L = 512 (the s4_1d layers' operands, whose
    Woodbury combination cancels near some roots), 2 channels x 4
    features."""
    ch, h, n, L = 2, 4, 64, 512
    lam, p, b, _ = ssm.make_dplr_hippo(n)
    lam, p, b = (t(np.broadcast_to(z, (h, n)).astype(np.complex64))
                 for z in (lam, p, b))
    C = t(((rng.standard_normal((ch * h, n))
            + 1j * rng.standard_normal((ch * h, n))) * 0.5 ** 0.5
           ).astype(np.complex64))
    log_dt = t(np.log(rng.uniform(1e-3, 1e-1, h)).astype(np.float32))
    args = (lam, p, b, C, log_dt)
    ref = cauchy.dplr_at_roots_reference(*args, L)
    scale = cauchy.dplr_at_roots_scale(*args, L)
    assert scale.shape == (ch * h, L) and bool((scale > 0).all())
    reversed_states = cauchy.dplr_at_roots_reference(
        *(a.flip(-1) for a in args[:4]), log_dt, L)
    in_f64 = cauchy.dplr_at_roots_reference(
        *(a.to(torch.complex128) for a in args[:4]), log_dt.double(),
        L).to(torch.complex64)
    faulty = C.clone()
    faulty[:, n // 2] *= 1 + 2.0 ** -10
    fault = cauchy.dplr_at_roots_reference(lam, p, b, faulty, log_dt, L)
    limit = cauchy.AT_ROOTS_LIMIT
    assert cauchy.at_roots_departure(reversed_states, ref, scale) <= limit
    assert cauchy.at_roots_departure(in_f64, ref, scale) <= limit
    assert cauchy.at_roots_departure(fault, ref, scale) > 25 * limit
