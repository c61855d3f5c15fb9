"""Frozen operation and byte counts of the work the hand kernels' functions
need, whatever implements them.

A roofline share or an MFU divides such a count by a time. The counts are
of the mathematics (a recompute, a padded tile or a DFT factor read by an
implementation is not counted), so a later change to a kernel cannot move
its own yardstick. Operations: 2 a multiply-add. Bytes: each input read
once and each output written once, at the element size given.
"""

from __future__ import annotations

import math


def _chain_macs(dims) -> int:
    return sum(a * b for a, b in zip(dims, dims[1:]))


def _chain_params(dims, layer_norm: bool = True) -> int:
    return (_chain_macs(dims) + sum(dims[1:])
            + (2 * dims[-1] if layer_norm else 0))


def ff_forward(rows: int, dims, e: int, residual: bool = True) -> tuple:
    """(operations, bytes) of the FeedForward chain ``dims`` over ``rows``
    rows (the fused forward, K1f): its products, 2 rows sum d_i d_i+1;
    x and out (and the residual added to out) in ``e`` bytes, the f32
    parameters once."""
    ops = 2.0 * rows * _chain_macs(dims)
    acts = rows * (dims[0] + dims[-1] + (dims[-1] if residual else 0)) * e
    return ops, float(acts + 4 * _chain_params(dims))


def ff_backward(rows: int, dims, e: int) -> tuple:
    """(operations, bytes) of the chain's backward (K1b): the gradients of
    the inputs and of the weights, twice the forward's products (no
    recompute); x, g and dx in ``e`` bytes, the f32 parameters read and
    their gradients written once."""
    ops = 4.0 * rows * _chain_macs(dims)
    acts = rows * (2 * dims[0] + dims[-1]) * e
    return ops, float(acts + 2 * 4 * _chain_params(dims))


def dft_ops(n: int, m: int) -> float:
    """One channel's truncated DFT of n points to m modes, or its inverse:
    the cheaper of a real FFT (2.5 n log2 n) and the dense product (4 n m)."""
    return min(2.5 * n * math.log2(n), 4.0 * n * m)


def spectral_pass(rows: int, n: int, c: int, o: int, m: int,
                  e: int) -> tuple:
    """(operations, bytes) of one axis pass (or its adjoint) of ``rows``
    rows of n points, c channels in and o out, m modes: each channel's
    forward and inverse DFT, and the complex mix, 8 c o a mode; x read and
    out written once in ``e`` bytes, and the complex weight (m c o, two f32
    each). The DFT factors are not counted: an FFT reads none."""
    ops = rows * ((c + o) * dft_ops(n, m) + 8.0 * m * c * o)
    return ops, float(rows * n * (c + o) * e + m * c * o * 2 * 4)


def vandermonde(rows: int, h: int, n: int, L: int) -> tuple:
    """(operations, bytes) of the S4D kernel (K4) for ``rows`` rows (channels
    x features) of ``L`` positions from ``n`` states of ``h`` features: per
    (row, state, position) 2 FMAs on a table of powers, the table's 32
    powers and the L / 32 anchors of each (feature, state) at 17 each, per
    (row, state) dtA and C' (27) and C' times each anchor (6), per (row,
    position) 2 (the count of Gu et al.'s S4D kernel as the one-launch
    form computes it). Bytes: A, C and dt read, the kernel written, f32."""
    anchors = -(-L // 32)
    ops = (4.0 * rows * n * L + 2.0 * rows * L
           + 17.0 * h * n * (32 + anchors)
           + rows * n * (27.0 + 6.0 * anchors))
    nbytes = 4 * (2 * h * n + 2 * rows * n + h + rows * L)
    return ops, float(nbytes)


def bound_s(ops: float, nbytes: float, peak_flops: float,
            peak_bytes: float) -> float:
    """The least time the chip could take: the larger of operations over
    the peak rate and bytes over the peak bandwidth."""
    return max(ops / peak_flops, nbytes / peak_bytes)
