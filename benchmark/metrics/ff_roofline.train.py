"""The FeedForward kernels' share of their roofline in a training step:
K1f (fused_ff.cu) and K1b (fused_ff_bwd.cu, its slab reduction with it),
a launch a layer each, counted by costs.ff_forward and costs.ff_backward."""
from benchmark import costs, readings

FORWARD = ("fused_ff_fwd",)
BACKWARD = ("fused_ff_bwd", "reduce_slabs_kernel")


def read(r):
    pts, dims, _, _, _, e = readings.ffno_shapes(r)
    layers = r.cfg["model"]["n_layers"]
    fwd = costs.ff_forward(pts, dims, e)
    bwd = costs.ff_backward(pts, dims, e)
    return readings.roofline(r, [
        (FORWARD, (layers * fwd[0], layers * fwd[1])),
        (BACKWARD, (layers * bwd[0], layers * bwd[1]))])
