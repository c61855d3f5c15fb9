"""The benchmark of resolution_pde_tpu_torch on one NVIDIA H100: one cell
(a model configuration under a traffic mix) a run, ``python3
benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>``
from the root of a checkout. ``BENCHMARK.json`` at the root lists the
cells and metrics."""
