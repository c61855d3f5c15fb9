"""The S4D kernel's (K4, vandermonde.cu) share of its roofline in a request:
one launch an axis a layer, each kernel of L positions over the grid's axis,
counted by costs.vandermonde."""
from benchmark import costs, readings

PATTERNS = ("vandermonde_kernel",)


def read(r):
    m = r.cfg["model"]
    d, n = m["d_model"], m["d_state"] // 2
    ops = nbytes = 0.0
    for L in r.traffic["grid"]:
        o, b = costs.vandermonde(d, d, n, L)
        ops, nbytes = ops + o, nbytes + b
    k = m["n_layers"]
    return readings.roofline(r, [(PATTERNS, (k * ops, k * nbytes))])
