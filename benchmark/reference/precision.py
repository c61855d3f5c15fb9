"""Rounding of a reference's operands to a lower precision, for the controls.

A control is the plain reference computed one precision below what a
configuration states: float8 (e4m3, one scale a tensor) under a bf16
configuration, TF32 under an f32 one with TF32 off. The rounding is written
out on the bits, so that it acts the same on the CPU and on the card, where a
backend flag would act on some products only. Each function rounds the
forward value and passes the gradient straight through, so a control's
training step runs at the rounded point.
"""

from __future__ import annotations

import torch

_E4M3_MAX = 448.0


def _straight_through(t: torch.Tensor, rounded: torch.Tensor) -> torch.Tensor:
    return t + (rounded - t).detach()


def exact(t: torch.Tensor) -> torch.Tensor:
    """No rounding: the reference itself."""
    return t


def fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under one scale for the whole tensor (its
    largest magnitude mapped to 448), as a float8 product reads it."""
    with torch.no_grad():
        amax = t.detach().abs().amax().float().clamp(min=1e-30)
        scale = _E4M3_MAX / amax
        r = (t.detach().float() * scale).to(torch.float8_e4m3fn).float()
        r = r / scale
    return _straight_through(t, r.to(t.dtype))


def bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bfloat16, as a bf16 product reads it: the yardstick of a
    bf16 configuration's gaps (the cost of its precision alone)."""
    with torch.no_grad():
        r = t.detach().to(torch.bfloat16).to(t.dtype)
    return _straight_through(t, r)


def tf32(t: torch.Tensor) -> torch.Tensor:
    """t rounded to TF32 (10 explicit mantissa bits, to nearest, ties to
    even), as a TF32 tensor-core product reads an f32 operand."""
    with torch.no_grad():
        bits = t.detach().float().contiguous().view(torch.int32)
        lsb = (bits >> 13) & 1
        r = ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)
    return _straight_through(t, r.to(t.dtype))


# the control of each stated precision: one step below it
CONTROL = {"bf16": fp8, "f32": tf32}
# the rounding whose gap is the unit of a precision's output gaps: none for
# f32 (its gaps are read as they are), bf16 itself for bf16
UNIT = {"bf16": bf16}
