"""One CUDA graph for a solver's repeated steps.

A pseudo-spectral step is dozens of small launches, which leave the
device idle most of the time when launched one by one; the solvers of
this package capture one snapshot's steps once and replay them.
"""

from __future__ import annotations

import torch


def graphed(fn, example):
    """``fn`` (a tensor to a tensor of its shape) captured in a CUDA graph
    on ``example``'s shape: the returned function copies its argument into
    the graph's input, replays, and returns a copy of the output. A first
    run on a side stream makes cuFFT's plans before the capture."""
    static_in = example.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(static_in)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_out = fn(static_in)

    def replay(v):
        static_in.copy_(v)
        graph.replay()
        return static_out.clone()

    return replay
