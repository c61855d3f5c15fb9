"""2D training driver (reference main_2d.py:37-325).

    python -m resolution_pde_tpu_torch.cli.main_2d model=ffno_2d \\
        dataset=ns_naive training.epochs=100

Counterpart of resolution_pde_tpu/cli/main_2d.py: main_1d with
``spatial_ndim=2``, the StepLR schedule (main_2d.py:173-174), and
``ffno_2d`` on ``ns_naive`` unless the arguments pick others. It runs on
``device`` (the card unless the caller passes "cpu"); under ``torchrun``
it trains data-parallel over every rank and multiplies the batch by the
data extent, as JAX's main_1d does with its mesh:

    torchrun --standalone --nproc_per_node=1 \
        -m resolution_pde_tpu_torch.cli.main_2d model=ffno_2d ...
"""

from __future__ import annotations

import sys

from resolution_pde_tpu_torch.cli.main_1d import main as _main


def main(argv=None, device="cuda"):
    argv = list(argv if argv is not None else sys.argv[1:])
    if not any(a.startswith("training.scheduler=") for a in argv):
        argv.append("training.scheduler=step")
    if not any(a.startswith("dataset=") for a in argv):
        argv.append("dataset=ns_naive")
    if not any(a.startswith("model=") for a in argv):
        argv.append("model=ffno_2d")
    return _main(argv, spatial_ndim=2, device=device)


if __name__ == "__main__":
    main()
