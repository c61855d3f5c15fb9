"""The FeedForward forward kernel's (K1f, fused_ff.cu) share of its
roofline in a request, a launch a layer, counted by costs.ff_forward."""
from benchmark import costs, readings

FORWARD = ("fused_ff_fwd",)


def read(r):
    pts, dims, _, _, _, e = readings.ffno_shapes(r)
    layers = r.cfg["model"]["n_layers"]
    fwd = costs.ff_forward(pts, dims, e)
    return readings.roofline(r, [(FORWARD, (layers * fwd[0],
                                            layers * fwd[1]))])
