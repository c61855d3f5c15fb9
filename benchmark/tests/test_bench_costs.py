"""The frozen counts at the four cells' shapes, pinned: K1f and K1b (the
backward twice the forward's products, no recompute), the spectral pass
(no DFT factors), K4, and each model's operations."""

import json
import math

import pytest

from benchmark import costs
from benchmark.reference import ffno2d, s4nd
from benchmark.tests.conftest import ROOT

CHAIN = [64, 256, 256, 64]


def _cfg(name):
    return json.loads((ROOT / "benchmark" / "configs" /
                       f"{name}.json").read_text())


@pytest.mark.parametrize("rows,ops", [
    (32 * 256 * 256, 412316860416.0),   # the train cell's 2,097,152 rows
    (8 * 256 * 256, 103079215104.0),    # the serve cell's rows
])
def test_feedforward_forward(rows, ops):
    got_ops, got_bytes = costs.ff_forward(rows, CHAIN, 2)
    assert got_ops == ops
    params = 64 * 256 + 256 * 256 + 256 * 64 + 256 + 256 + 64 + 2 * 64
    assert got_bytes == rows * (64 + 64 + 64) * 2 + 4 * params


def test_feedforward_backward_is_twice_the_forward():
    rows = 32 * 256 * 256
    ops, nbytes = costs.ff_backward(rows, CHAIN, 2)
    assert ops == 2 * costs.ff_forward(rows, CHAIN, 2)[0] == 824633720832.0
    params = 64 * 256 + 256 * 256 + 256 * 64 + 256 + 256 + 64 + 2 * 64
    assert nbytes == rows * (64 + 64 + 64) * 2 + 8 * params


def test_spectral_pass_counts_no_factors():
    # one W pass of the train cell: 32 x 256 rows of 256 points, 64 modes
    ops, nbytes = costs.spectral_pass(32 * 256, 256, 64, 64, 64, 2)
    fft = 2.5 * 256 * 8            # cheaper than the dense 4 n m = 65,536
    assert ops == 32 * 256 * (128 * fft + 8 * 64 * 64 * 64)
    assert ops == 22548578304.0
    assert nbytes == 32 * 256 * 256 * 128 * 2 + 64 * 64 * 64 * 8


def test_vandermonde_at_s4nd_shapes():
    ops, nbytes = costs.vandermonde(64, 64, 32, 256)
    assert ops == (4 * 64 * 32 * 256 + 2 * 64 * 256 + 17 * 64 * 32 * 40
                   + 64 * 32 * (27 + 48)) == 3676160.0
    assert nbytes == 4 * (2 * 64 * 32 + 2 * 64 * 32 + 64 + 64 * 256)


def test_bound_is_the_larger_side():
    assert costs.bound_s(989e12, 1.0, 989e12, 3.35e12) == 1.0
    assert costs.bound_s(1.0, 3.35e12, 989e12, 3.35e12) == 1.0


def test_ffno2d_operations():
    cfg = _cfg("ffno2d_ns256")
    per_sample = ffno2d.flops(cfg, 1, (256, 256))
    pts = 256 * 256
    passes = 2 * 256 * (128 * 2.5 * 256 * 8 + 8 * 64 ** 3)
    want = (2 * pts * (3 * 64 + 64 * 1)
            + 4 * (2 * pts * (64 * 256 + 256 * 256 + 256 * 64) + passes))
    assert per_sample == want
    assert math.isclose(per_sample, 57.2e9, rel_tol=2e-3)
    assert ffno2d.flops(cfg, 32, (256, 256)) == 32 * per_sample


@pytest.mark.parametrize("grid,gflop", [((256, 256), 10.633),
                                        ((128, 128), 2.503)])
def test_s4nd_operations(grid, gflop):
    cfg = _cfg("s4nd_ns")
    h, w = grid
    big = 4 * h * w
    kernels = sum(costs.vandermonde(64, 64, 32, n)[0] for n in grid)
    layer = (2 * 2.5 * big * math.log2(big) * 64 + 6 * 64 * 2 * h * (w + 1)
             + 2 * 64 * h * w + 2 * h * w * 64 * 128 + kernels)
    want = 2 * h * w * (3 * 64 + 64) + 4 * layer
    assert s4nd.flops(cfg, 1, grid) == want
    assert math.isclose(want / 1e9, gflop, rel_tol=2e-3)
