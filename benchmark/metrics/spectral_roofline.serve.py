"""The spectral kernels' share of their roofline in a request: two passes a
layer, counted by costs.spectral_pass."""
from benchmark import readings

PATTERNS = ("staged_forward_kernel", "staged_mix_kernel",
            "staged_inverse_kernel", "spectral_pass_kernel")


def read(r):
    return readings.roofline(r, [(PATTERNS,
                                  readings.spectral_unit(r, False))])
