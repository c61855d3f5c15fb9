#!/usr/bin/env python3
"""The work of ScOT at pos.yaml's widths with one input and output channel
(embed 96, depths 8/8/8/8, heads 3/6/12/24, window 16: 101.3 M
parameters), counted on the CPU for one sample:

    python3 scripts/torch_scot_cost.py [128 256 ...]

Prints, per grid size, the parameters and the FLOPs of a forward and of a
forward and backward (torch.utils.flop_counter.FlopCounterMode: the
matrix products and convolutions; softmax, LayerNorm, GELU and the
position-bias gathers are not counted). A step of batch B is B times
these. The model is built on the meta device, so nothing is computed and
nothing runs on a card.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    from resolution_pde_tpu_torch.models.poseidon import ScOT2d

    sizes = [int(a) for a in (argv if argv is not None else sys.argv[1:])]
    with torch.device("meta"):
        model = ScOT2d(num_channels=1, num_out_channels=1)
    n_params = sum(p.numel() for p in model.parameters())
    for size in sizes or [128]:
        x = torch.randn(1, 1, size, size, device="meta")
        fwd = FlopCounterMode(display=False)
        with fwd:
            model(x)
        step = FlopCounterMode(display=False)
        with step:
            model(x)["output"].sum().backward()
        print(f"ScOT (pos.yaml, 1 channel) {size}x{size}: parameters "
              f"{n_params} forward {fwd.get_total_flops() / 1e9:.2f} GFLOP "
              f"forward+backward {step.get_total_flops() / 1e9:.2f} GFLOP "
              "a sample", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
