#!/usr/bin/env python3
"""Device time of the fused FeedForward backward (K1b) by phase, on one GPU.

    python3 scripts/torch_k1b_phases.py [--out build/k1b_phases]

Builds csrc/fused_ff_bwd.cu alone with RPDE_K1B_PHASES, which makes thread
0 of every block add the clock cycles from one barrier to the next into a
counter per phase (the phase marks add barriers of their own), and runs it
at the train shape of chip_smoke.py (8 x 256² = 524,288 rows, 64 -> 256
-> 256 -> 64, LayerNorm, tanh GELU, bf16; random inputs from seed 0), with
the pre-activations recomputed and saved. For each it prints the
instrumented kernel's median time (CUDA events) split over the phases in
proportion to their cycles, and the time of the library's own build
beside it. Prints the card's name and power limit first. Needs CUDA and
nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
import types
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

MAX_LAYERS = 32  # kMaxLayers of csrc/fused_ff.cuh
N_PHASES = 3 + 3 * MAX_LAYERS + 1


def _phase_names(n_layers: int) -> dict:
    names = {0: "x", 1: "recompute_or_zs", 2: "last_dz_ln"}
    for l in range(n_layers):
        names[3 + 3 * l] = f"dW{l}"
        names[4 + 3 * l] = "dx" if l == 0 else f"dh{l}"
        if l > 0:
            names[5 + 3 * l] = f"db{l - 1}_h{l - 1}"
    names[N_PHASES - 1] = "tile_end"
    return names


def _time_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/k1b_phases")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k1b_phases: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    from resolution_pde_tpu_torch.ops.kernels import _build, fused_ff

    lib = _build.library()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libk1b_phases.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DRPDE_K1B_PHASES",
                    "-shared", "-o", str(so),
                    str(_build.CSRC / "fused_ff_bwd.cu")], check=True)
    phased = ctypes.CDLL(str(so))
    bwd = phased.rpde_fused_ff_backward
    bwd.argtypes = _build._SIGNATURES["rpde_fused_ff_backward"]
    bwd.restype = ctypes.c_int
    counters = phased.rpde_k1b_phase_cycles
    counters.argtypes = [ctypes.c_void_p, ctypes.c_int]
    counters.restype = ctypes.c_int
    phased_lib = types.SimpleNamespace(
        rpde_fused_ff_backward=bwd,
        rpde_fused_ff_backward_slab=lib.rpde_fused_ff_backward_slab)

    gen = torch.Generator().manual_seed(0)

    def randn(shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen) * scale).to("cuda", dtype)

    n, dims = 8 * 256 * 256, [64, 256, 256, 64]
    ks = [randn((a, b), a ** -0.5) for a, b in zip(dims, dims[1:])]
    bs = [randn((d,), 0.1) for d in dims[1:]]
    ln = (1.0 + randn((dims[-1],), 0.1), randn((dims[-1],), 0.1))
    x = randn((n, dims[0]), dtype=torch.bfloat16)
    g = randn((n, dims[-1]), dtype=torch.bfloat16)
    kw = dict(approx_gelu=True, compute_dtype=torch.bfloat16)
    _, zs = fused_ff.fused_feedforward_fwd(x, ks, bs, ln, save_acts=True, **kw)
    names = _phase_names(len(ks))
    for label, z in (("recompute", None), ("saved", zs)):
        def run():
            return fused_ff.fused_feedforward_bwd(x, g, ks, bs, ln, zs_saved=z,
                                                  **kw)
        plain_ms = _time_ms(run)
        _build.library = lambda: phased_lib
        try:
            run()
            torch.cuda.synchronize()
            _build.check(counters(None, 1), "rpde_k1b_phase_cycles")
            ms = _time_ms(run)
            cycles = (ctypes.c_ulonglong * N_PHASES)()
            _build.check(counters(cycles, 0), "rpde_k1b_phase_cycles")
        finally:
            _build.library = lambda: lib
        total = sum(cycles)
        split = {names.get(i, str(i)): round(c / total * ms, 4)
                 for i, c in enumerate(cycles) if c}
        print(f"K1b {label}: kernel {plain_ms:.4f} ms, with phase marks "
              f"{ms:.4f} ms; by phase (ms): {split}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
