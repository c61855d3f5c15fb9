"""The operations of the hand kernels a model launches, summed while
``count_operations()`` is open.

FlopCounterMode sees PyTorch's own operators but not a kernel launched
through ctypes, so each kernel entry adds its own count (the one
``chip_smoke.py``'s bounds use: ``fused_ff.cost``,
``spectral_mix.pass_cost``, ``vandermonde.operations``,
``cauchy.operations``) where it launches its kernel: the FeedForward
forward and backward, the spectral pass and adjoint, and the S4 kernels'
model entries (``s4d_kernel_pallas``, ``dplr_at_roots``). Nothing is
counted while no tally is open.
"""

from __future__ import annotations

import contextlib

_TALLIES: list = []


@contextlib.contextmanager
def count_operations():
    """Yields a dict whose "operations" grows by each hand kernel's
    operation count as it launches inside the block."""
    tally = {"operations": 0.0}
    _TALLIES.append(tally)
    try:
        yield tally
    finally:
        _TALLIES.remove(tally)


def add(count_fn, *args) -> None:
    """Add ``count_fn(*args)`` to every open tally (computed only when one
    is open)."""
    if _TALLIES:
        ops = count_fn(*args)
        for tally in _TALLIES:
            tally["operations"] += ops
