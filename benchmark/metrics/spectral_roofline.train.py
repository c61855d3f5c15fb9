"""The spectral kernels' share of their roofline in a training step: the
staged route's three stages (spectral_staged.cu) or the f32 pass
(spectral_mix.cu), two passes a layer and their two adjoints, counted by
costs.spectral_pass."""
from benchmark import readings

PATTERNS = ("staged_forward_kernel", "staged_mix_kernel",
            "staged_inverse_kernel", "spectral_pass_kernel")


def read(r):
    return readings.roofline(r, [(PATTERNS,
                                  readings.spectral_unit(r, True))])
