#!/usr/bin/env python3
"""Device time of the fused FeedForward forward (K1f) by phase, on one GPU.

    python3 scripts/torch_k1f_phases.py [--f32] [--out build/k1f_phases]
    python3 scripts/torch_k1f_phases.py --sass DIR [--sass DIR ...]

Builds csrc/fused_ff.cu alone twice, both nvcc runs started together, with
``-Xptxas -v``: as the library builds it (the kernel's registers, stack
and spills are printed, without the saved pre-activations) and with
RPDE_K1F_PHASES, which makes thread 0 of every block add the clock cycles
of each phase into a counter. bf16 (the tensor-core kernel): the first
slices' copies and the x tile; waiting for a slice; starting a slice's
copies; the products; the epilogues; the LayerNorm and the stores. With
``--f32`` the f32-exact mode (its kernel on f32_tile_gemm): the x tile and
the first copies; the first layer; the layers between; the last layer;
the LayerNorm and the stores (each layer its products, epilogue and the
waits in them). With ``--sass DIR`` (repeatable) instead: builds the
csrc/fused_ff.cu of the checkout in each DIR alone, all at once, and
prints its planner's route and tile rows (bf16, x and out in bf16, with
the residual) for the bench chain, width 128's and the factor-4 chains at
320 and 512, and for each bf16 forward kernel its SASS instructions'
count and the first 16 hex digits of the SHA-1 of their text (addresses
and encodings left out), so that two trees' plans and kernels are
compared. Runs both at the train shape of chip_smoke.py (8 x 256² =
524,288 rows, 64 -> 256 -> 256 -> 64, LayerNorm, residual, tanh GELU, x
and out in the compute type; random inputs from seed 0), each checked
against the plain forward (relative L2, tolerance 1e-2 in bf16, where
rounding flips move an element by one bf16 ulp; 1e-4 in f32, where only
the order of the sums differs), and prints the planner's route and tile
rows, the library build's median time (CUDA events) and its rate on the
products (103 GFLOP), the instrumented kernel's split over the phases in
proportion to their cycles, and the plain forward's. Prints the card's
name and power limit first. Needs CUDA and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import re
import statistics
import subprocess
import sys
import types
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# per mode: compute dtype, tolerance, the phase counters and their names,
# and the ptxas entry of the kernel (io in the compute type, no zs)
MODES = {
    "bf16": dict(
        dtype=torch.bfloat16, tol=1e-2, counters="rpde_k1f_phase_cycles",
        phases=["first_copies_and_x", "wait_for_slice", "start_copies",
                "products", "epilogues", "layernorm_and_stores"],
        ptxas=lambda line: ("fused_ff_fwd_mma_kernel" in line
                            and "I13__nv_bfloat16Lb0ELb0E" in line)),
    "f32": dict(
        dtype=torch.float32, tol=1e-4, counters="rpde_k1f_f32_phase_cycles",
        phases=["x_and_first_copies", "first_layer", "middle_layers",
                "last_layer", "layernorm_and_stores"],
        ptxas=lambda line: ("fused_ff_fwd_f32_kernel" in line
                            and "IfLb0ELb0E" in line)),
}


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


def print_sass(roots: list, out: Path) -> None:
    """Each checkout's csrc/fused_ff.cu: its planner's plan of a few bf16
    chains, and its bf16 forward kernels' SASS instructions' count and
    text hash (``--sass``)."""
    from resolution_pde_tpu_torch.ops.kernels import _build

    nvcc = _build._nvcc()
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, root in enumerate(roots):
        so = out / f"fused_ff_{i}.so"
        src = Path(root) / "resolution_pde_tpu_torch" / "csrc" / "fused_ff.cu"
        procs.append((root, so, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for root, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {root}:\n{log}")
        route = ctypes.CDLL(str(so)).rpde_fused_ff_forward_route
        route.argtypes = _build._SIGNATURES["rpde_fused_ff_forward_route"]
        for w in (64, 128, 320, 512):
            dims = [w, 4 * w, 4 * w, w]
            rows = (ctypes.c_int * 1)()
            got = route(1, 1, 1, (ctypes.c_int * 4)(*dims), 3, rows)
            print(f"{root}: plan {'->'.join(map(str, dims))} bf16: route "
                  f"{got}, tile rows {rows[0]}", flush=True)
        dump = subprocess.run(
            [str(Path(nvcc).with_name("cuobjdump")), "-sass", str(so)],
            capture_output=True, text=True, check=True, timeout=300).stdout
        for part in dump.split("Function : ")[1:]:
            name = part.split(None, 1)[0]
            if "fused_ff_fwd_mma_kernel" not in name:
                continue
            ins = re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", part)
            digest = hashlib.sha1("\n".join(i.strip() for i in ins).encode())
            args = name.split("fused_ff_fwd_mma_kernel", 1)[1].split("EEv")[0]
            print(f"{root}: sass fused_ff_fwd_mma_kernel{args}: {len(ins)} "
                  f"instructions, sha1 {digest.hexdigest()[:16]}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/k1f_phases")
    ap.add_argument("--f32", action="store_true",
                    help="the f32-exact mode instead of bf16")
    ap.add_argument("--sass", action="append", default=[],
                    help="a checkout whose bf16 forward kernels' SASS to "
                    "print instead (repeatable)")
    args = ap.parse_args()
    if args.sass:
        print_sass(args.sass, Path(args.out) / "sass")
        return 0
    mode = "f32" if args.f32 else "bf16"
    spec = MODES[mode]
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
    out = Path(args.out) / mode
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
            if "Compiling entry" in line and spec["ptxas"](line):
                info = " | ".join(t.split("ptxas info    :")[-1].strip()
                                  for t in lines[i + 2:i + 4])
                print(f"{name}: {info}", flush=True)
        so = ctypes.CDLL(str(out / f"libk1f_{name}.so"))
        fn = so.rpde_fused_ff_forward
        fn.argtypes = _build._SIGNATURES["rpde_fused_ff_forward"]
        fn.restype = ctypes.c_int
        libs[name] = types.SimpleNamespace(rpde_fused_ff_forward=fn)
        if name == "phases":
            counters = getattr(so, spec["counters"])
            counters.argtypes = [ctypes.c_void_p, ctypes.c_int]
            counters.restype = ctypes.c_int

    gen = torch.Generator().manual_seed(0)

    def randn(shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen) * scale).to("cuda", dtype)

    n, dims = 8 * 256 * 256, [64, 256, 256, 64]
    ks = [randn((a, b), a ** -0.5) for a, b in zip(dims, dims[1:])]
    bs = [randn((d,), 0.1) for d in dims[1:]]
    ln = (1.0 + randn((dims[-1],), 0.1), randn((dims[-1],), 0.1))
    cd, tol = spec["dtype"], spec["tol"]
    x = randn((n, dims[0]), dtype=cd)
    res = randn((n, dims[-1]), dtype=cd)
    kw = dict(approx_gelu=True, compute_dtype=cd)
    rows = (ctypes.c_int * 1)()
    route = lib.rpde_fused_ff_forward_route(
        int(cd == torch.bfloat16), int(cd == torch.bfloat16), 1,
        (ctypes.c_int * len(dims))(*dims), len(dims) - 1, rows)
    print(f"route {route} (1 tensor cores, 2 f32 tiles, 3 f32 wide), "
          f"tile rows {rows[0]}", flush=True)
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
            print(f"{name}: rel_l2 {err:.3e} (tol {tol})", flush=True)
            if not err <= tol:
                raise AssertionError(f"{name} disagrees with the plain forward")
            if name == "phases":
                _build.check(counters(None, 1), spec["counters"])
            ms[name] = _time_ms(run)
        cycles = (ctypes.c_ulonglong * len(spec["phases"]))()
        _build.check(counters(cycles, 0), spec["counters"])
    finally:
        _build.library = lambda: lib
    total = sum(cycles)
    split = {p: round(c / total * ms["phases"], 4)
             for p, c in zip(spec["phases"], cycles)}
    gflop = 2.0 * n * sum(a * b for a, b in zip(dims, dims[1:])) / 1e9
    print(f"K1f {mode}: kernel {ms['library']:.4f} ms "
          f"({gflop / ms['library']:.1f} TFLOP/s of its products; plain "
          f"{plain:.4f} ms), with phase marks {ms['phases']:.4f} ms; by "
          f"phase (ms): {split}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
