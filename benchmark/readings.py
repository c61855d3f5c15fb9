"""What the per-layer metrics share: a reading of a traced run turned into a
peak share, an idle share, a roofline share or a device time.

A reading (``harness.run``) holds the configuration and traffic, the card's
peaks (None for a card not in peaks.json), the trace of the segment
(``trace``, ``seg_s``, ``seg_units``: steps or requests), the untraced first
half's units and seconds (``pre_units``, ``pre_s``), the memory peak, the
model's operations a unit and the configuration's precision.
"""

from __future__ import annotations

from benchmark import costs

# every kernel of the program written by hand (resolution_pde_tpu_torch/csrc),
# by a part of its symbol name
HAND_KERNELS = ("fused_ff_fwd", "fused_ff_bwd", "reduce_slabs_kernel",
                "staged_forward_kernel", "staged_mix_kernel",
                "staged_inverse_kernel", "spectral_pass_kernel",
                "vandermonde_kernel", "cauchy_kernel")
ELEMENT_BYTES = {"bf16": 2, "f32": 4}


def mfu(r) -> float | None:
    """The untraced half's model operations a second over the chip's peak
    at the configuration's precision, in %."""
    if r.peaks is None or r.pre_units == 0 or r.pre_s <= 0:
        return None
    return 100.0 * r.pre_units * r.flops_per_unit / r.pre_s \
        / r.peaks[r.precision]


def idle_share(r) -> float | None:
    """The share of the segment in which no operation ran on the device, %."""
    if not r.trace.device or r.seg_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.seg_s)


def peak_gib(r) -> float | None:
    return r.memory_peak_bytes / 2 ** 30 if r.memory_peak_bytes else None


def roofline(r, groups) -> float | None:
    """The least time of the found kernel groups' work over their device
    time, %. ``groups``: [(symbol patterns, (operations, bytes) a unit of
    the traffic)]; a group whose patterns match no kernel is left out, and
    with none found there is no reading."""
    if r.peaks is None:
        return None
    least = spent = 0.0
    for patterns, (ops, nbytes) in groups:
        secs, launches = r.trace.kernel_s(patterns)
        if launches:
            least += r.seg_units * costs.bound_s(
                ops, nbytes, r.peaks[r.precision], r.peaks["bytes_per_s"])
            spent += secs
    return 100.0 * least / spent if spent > 0 else None


def other_ms(r) -> float | None:
    """Device ms a unit of every operation that is not a hand kernel."""
    if not r.trace.device or r.seg_units == 0:
        return None
    secs = sum((t - s) / 1e6 for n, s, t in r.trace.device
               if not any(p in n for p in HAND_KERNELS))
    return 1e3 * secs / r.seg_units


def ffno_shapes(r) -> tuple:
    """(points a unit, FeedForward chain, H, W, rows, element bytes)."""
    m, tr = r.cfg["model"], r.traffic
    h, w = tr["grid"]
    width = m["width"]
    dims = ([width] + [width * m["factor"]] * (m["n_ff_layers"] - 1)
            + [width])
    return (tr["rows"] * h * w, dims, h, w, tr["rows"],
            ELEMENT_BYTES[r.precision])


def spectral_unit(r, with_adjoint: bool) -> tuple:
    """(operations, bytes) of a unit's spectral passes: per layer one along
    W and one along H, and as many adjoints in training."""
    m = r.cfg["model"]
    _, _, h, w, rows, e = ffno_shapes(r)
    ops = nbytes = 0.0
    for n, n_rows in ((w, rows * h), (h, rows * w)):
        o, b = costs.spectral_pass(n_rows, n, m["width"], m["width"],
                                   min(m["n_modes"], n // 2 + 1), e)
        ops, nbytes = ops + o, nbytes + b
    k = m["n_layers"] * (2 if with_adjoint else 1)
    return k * ops, k * nbytes
