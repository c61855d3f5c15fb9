#!/usr/bin/env python3
"""The work of a CNO2d train step at cno_2d.yaml's widths (4 levels, 4
residual blocks a level and in the neck, multiplier 32), counted on the
CPU for one sample:

    python3 scripts/torch_cno_cost.py [128 256 ...]

Prints, per grid size, the parameters, the FLOPs of a forward and backward
(torch.utils.flop_counter.FlopCounterMode: the convolutions; the resizes,
BatchNorm and LeakyReLU are not counted) and the elements and f32 bytes
that the forward's antialiased resizes read and write (every
F.interpolate call's input and output). A step of batch B is B times
these. Nothing runs on a card.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    from resolution_pde_tpu_torch.models.cno import CNO2d

    sizes = [int(a) for a in (argv if argv is not None else sys.argv[1:])]
    for size in sizes or [128, 256]:
        model = CNO2d(1, 1, size, N_layers=4, N_res=4, N_res_neck=4,
                      channel_multiplier=32,
                      generator=torch.Generator().manual_seed(0))
        x = torch.randn(1, 1, size, size)
        counter = FlopCounterMode(display=False)
        with counter:
            model(x).sum().backward()
        moved = [0]
        interpolate = F.interpolate

        def counted(inp, *args, **kwargs):
            out = interpolate(inp, *args, **kwargs)
            moved[0] += inp.numel() + out.numel()
            return out

        F.interpolate = counted
        try:
            with torch.no_grad():
                model(x)
        finally:
            F.interpolate = interpolate
        params = sum(p.numel() for p in model.parameters())
        print(f"size {size}: parameters {params / 1e6:.2f} M, forward and "
              f"backward {counter.get_total_flops() / 1e9:.1f} GFLOP a "
              f"sample, forward resizes {moved[0] / 1e6:.1f} M elements "
              f"({moved[0] * 4 / 1e6:.0f} MB f32) a sample", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
