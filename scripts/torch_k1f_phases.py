#!/usr/bin/env python3
"""Device time of the fused FeedForward forward (K1f, bf16) by phase, on one GPU.

    python3 scripts/torch_k1f_phases.py [--out build/k1f_phases]

Builds csrc/fused_ff.cu alone twice, both nvcc runs started together, with
``-Xptxas -v``: as the library builds it (its tensor-core kernel's
registers, stack and spills are printed, for bf16 in and out without the
saved pre-activations) and with RPDE_K1F_PHASES, which makes thread 0 of
every block add the clock cycles of each phase into a counter (the first
slices' copies and the x tile; waiting for a slice; starting a slice's
copies; the products; the epilogues; the LayerNorm and the stores). Runs
both at the train shape of chip_smoke.py (8 x 256² = 524,288 rows, 64 ->
256 -> 256 -> 64, LayerNorm, residual, tanh GELU, bf16 in and out; random
inputs from seed 0), each checked against the plain forward (relative L2,
tolerance 1e-2: bf16 rounding flips), and prints the library build's
median time (CUDA events), the instrumented kernel's split over the phases
in proportion to their cycles, and the plain forward's. Prints the card's
name and power limit first. Needs CUDA and nvcc.
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

PHASES = ["first_copies_and_x", "wait_for_slice", "start_copies", "products",
          "epilogues", "layernorm_and_stores"]


def _time_ms(fn, reps: int = 20) -> float:
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


def _rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/k1f_phases")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k1f_phases: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    from resolution_pde_tpu_torch.ops.kernels import _build, fused_ff

    lib = _build.library()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    src = str(_build.CSRC / "fused_ff.cu")
    builds = {"library": [], "phases": ["-DRPDE_K1F_PHASES"]}
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-Xptxas", "-v",
         "-shared", "-o", str(out / f"libk1f_{name}.so"), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, flags in builds.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        # ptxas names each kernel on one line and gives its stack, spills
        # and registers on the next two
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if ("Compiling entry" in line and "fused_ff_fwd_mma_kernel" in line
                    and "I13__nv_bfloat16Lb0E" in line):
                info = " | ".join(t.split("ptxas info    :")[-1].strip()
                                  for t in lines[i + 2:i + 4])
                print(f"{name}: {info}", flush=True)
        so = ctypes.CDLL(str(out / f"libk1f_{name}.so"))
        fn = so.rpde_fused_ff_forward
        fn.argtypes = _build._SIGNATURES["rpde_fused_ff_forward"]
        fn.restype = ctypes.c_int
        libs[name] = types.SimpleNamespace(rpde_fused_ff_forward=fn)
        if name == "phases":
            counters = so.rpde_k1f_phase_cycles
            counters.argtypes = [ctypes.c_void_p, ctypes.c_int]
            counters.restype = ctypes.c_int

    gen = torch.Generator().manual_seed(0)

    def randn(shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen) * scale).to("cuda", dtype)

    n, dims = 8 * 256 * 256, [64, 256, 256, 64]
    ks = [randn((a, b), a ** -0.5) for a, b in zip(dims, dims[1:])]
    bs = [randn((d,), 0.1) for d in dims[1:]]
    ln = (1.0 + randn((dims[-1],), 0.1), randn((dims[-1],), 0.1))
    x = randn((n, dims[0]), dtype=torch.bfloat16)
    res = randn((n, dims[-1]), dtype=torch.bfloat16)
    kw = dict(approx_gelu=True, compute_dtype=torch.bfloat16)
    want = fused_ff.fused_feedforward_reference(x, ks, bs, ln, res, **kw)
    plain = _time_ms(lambda: fused_ff.fused_feedforward_reference(
        x, ks, bs, ln, res, **kw), reps=5)

    def run():
        return fused_ff.fused_feedforward_fwd(x, ks, bs, ln, res, **kw)[0]

    ms = {}
    try:
        for name in builds:
            _build.library = lambda name=name: libs[name]
            err = _rel_l2(run(), want)
            torch.cuda.synchronize()
            print(f"{name}: rel_l2 {err:.3e} (tol 1e-2)", flush=True)
            if not err <= 1e-2:
                raise AssertionError(f"{name} disagrees with the plain forward")
            if name == "phases":
                _build.check(counters(None, 1), "rpde_k1f_phase_cycles")
            ms[name] = _time_ms(run)
        cycles = (ctypes.c_ulonglong * len(PHASES))()
        _build.check(counters(cycles, 0), "rpde_k1f_phase_cycles")
    finally:
        _build.library = lambda: lib
    total = sum(cycles)
    split = {p: round(c / total * ms["phases"], 4)
             for p, c in zip(PHASES, cycles)}
    print(f"K1f bf16: kernel {ms['library']:.4f} ms (plain {plain:.4f} ms), "
          f"with phase marks {ms['phases']:.4f} ms; by phase (ms): {split}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
