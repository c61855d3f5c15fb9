"""The bf16 spectral weight gradient's kernels (csrc/spectral_staged.cu
``rpde_spectral_wgrad``) against their plain mirror
``weight_grad_staged_plain`` on an NVIDIA card, and their launches in a
training step. Every test is marked ``cuda`` and skips without a card: the
kernels have no CPU mode. On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_wgrad_cuda.py

The file imports no JAX and uses nothing of tests/conftest.py (which
imports JAX), so ``--noconftest`` runs it on a machine without JAX.

Tolerance, relative L2 2e-3: both sides multiply the same bf16 operands
exactly and sum in f32, in other orders. A spectrum element whose two f32
sums fall on either side of a bf16 rounding boundary rounds one way on each
side, which moves the gradient by about 1e-4 relative.
"""

import pytest
import torch

from resolution_pde_tpu_torch.ops.kernels import spectral_mix as sm

pytestmark = pytest.mark.cuda

BF = torch.bfloat16
TOL = 2e-3

# (B, H, W, C, O, n_modes): the CPU tests' ragged shapes (n no multiple of
# 64, odd m, C and O no multiple of 8) and the train cell's shape
CASES = [(2, 20, 40, 5, 3, 17), (1, 24, 15, 12, 20, 7),
         (1, 6, 40, 24, 40, 17), (32, 256, 256, 64, 64, 64)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the weight gradient's kernels "
                    "have no CPU mode")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


def _randn(card, shape, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen).to(card, BF)


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _check(x, g, m, axis):
    """The kernel twice (the same bits, two launches) against the mirror."""
    n = x.shape[axis]
    before = sm.wgrad_launches
    got = sm.spectral_weight_grad(x, g, m, axis, "ortho", BF)
    again = sm.spectral_weight_grad(x, g, m, axis, "ortho", BF)
    torch.cuda.synchronize()
    assert sm.wgrad_launches == before + 2
    assert torch.equal(got, again)
    a1x = sm.staged_factors(n, m, "ortho", x.device)[0]
    a1g = sm.staged_factors(n, m, "ortho", x.device, adjoint=True)[0]
    want = sm.weight_grad_staged_plain(x, g, a1x, a1g, m, axis)
    assert got.shape == want.shape == (m, 2, x.shape[3], g.shape[3])
    assert bool(torch.isfinite(got).all())
    assert _rel(got, want) <= TOL


@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("case", CASES,
                         ids=["-".join(map(str, k)) for k in CASES])
def test_kernel_matches_plain_mirror(card, case, axis):
    b, h, w, c, o, n_modes = case
    n = (h, w)[axis - 1]
    _check(_randn(card, (b, h, w, c), 1), _randn(card, (b, h, w, o), 2),
           min(n_modes, n // 2 + 1), axis)


@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("c", [64, 5])
def test_kernel_reads_strided_views(card, c, axis):
    """x a pencil of a wider grid, (B, H, W/4, C) columns of (B, H, W, C8),
    read in place through its strides: 64 channels (16-byte pieces by
    cp.async) and 5 channels sliced from 8 (pieces rounded element by
    element)."""
    c8 = -(-c // 8) * 8
    grid = _randn(card, (4, 64, 128, c8), 3)
    x = grid[:, :, 32:64, 1:1 + c] if c8 > c else grid[:, :, 32:64]
    g = _randn(card, tuple(x.shape[:3]) + (24,), 4)
    assert not x.is_contiguous()
    n = x.shape[axis]
    _check(x, g, min(17, n // 2 + 1), axis)


@pytest.mark.parametrize("spectral_impl,compute_dtype,per_step",
                         [("pallas2", BF, 8), ("pallas", None, 0)])
def test_wgrad_launches_per_train_step(card, spectral_impl, compute_dtype,
                                       per_step):
    """A FFNO2D step of 4 layers launches the kernels once per layer and
    axis in bf16 and never in the f32-exact mode."""
    from resolution_pde_tpu_torch.models import FFNO2D
    from resolution_pde_tpu_torch.train import Trainer

    model = FFNO2D(in_channels=1, out_channels=1, width=64, n_layers=4,
                   n_modes=16, factor=4, ff_weight_norm=True, n_ff_layers=3,
                   layer_norm=True, dropout=0.0, compute_dtype=compute_dtype,
                   spectral_impl=spectral_impl, approx_gelu=True,
                   ff_impl="fused", device="cuda",
                   generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, learning_rate=1e-3, device="cuda")
    state = trainer.init()
    x = _randn(card, (2, 1, 64, 64), 5).float()
    before = sm.wgrad_launches
    state, loss = trainer.train_step(state, x, x.roll(3, dims=-1))
    assert bool(torch.isfinite(torch.as_tensor(float(loss))))
    assert sm.wgrad_launches - before == per_step


def test_weight_grad_ranges_hold_only_its_kernels(card, tmp_path):
    """In a ``Trainer.profile_step`` trace of a FFNO2D bf16 step each of
    the 8 device-side ranges of ``rpde.spectral.weight_grad`` holds the
    three kernels and no f32 GEMM or strided copy (what the torch route
    ran there)."""
    import glob
    import json

    from resolution_pde_tpu_torch.models import FFNO2D
    from resolution_pde_tpu_torch.train import Trainer

    model = FFNO2D(in_channels=1, out_channels=1, width=64, n_layers=4,
                   n_modes=64, factor=4, ff_weight_norm=True, n_ff_layers=3,
                   layer_norm=True, dropout=0.0, compute_dtype=BF,
                   spectral_impl="pallas2", approx_gelu=True, ff_impl="fused",
                   device="cuda", generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, learning_rate=1e-3, device="cuda")
    x = _randn(card, (4, 1, 256, 256), 6).float()
    trainer.profile_step(trainer.init(), x, x.roll(3, dims=-1),
                         str(tmp_path), n_steps=1)
    (path,) = glob.glob(str(tmp_path / "*.json"))
    events = json.load(open(path))["traceEvents"]
    ranges = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "gpu_user_annotation"
              and e.get("name") == "rpde.spectral.weight_grad"]
    kernels = [(e["ts"], e["name"]) for e in events
               if e.get("cat") == "kernel"]
    assert len(ranges) == 8
    for t0, t1 in ranges:
        inside = [n for t, n in kernels if t0 <= t < t1]
        for part in ("wgrad_spectra_kernel", "wgrad_product_kernel",
                     "wgrad_reduce_kernel"):
            assert sum(part in n for n in inside) == 1, inside
        assert not [n for n in inside
                    if "gemm_f32f32" in n or "elementwise_kernel<128, 2" in n]
