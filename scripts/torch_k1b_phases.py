#!/usr/bin/env python3
"""Device time of the fused FeedForward backward (K1b) by phase, on one GPU.

    python3 scripts/torch_k1b_phases.py [--f32] [--sass] [--csrc DIR ...]
                                        [--out build/k1b_phases]
    python3 scripts/torch_k1b_phases.py --wide [--f32]

Builds csrc/fused_ff_bwd.cu alone, in parallel: as the library builds it,
and with RPDE_K1B_PHASES, which makes thread 0 of every block add the
clock cycles from one barrier to the next into a counter per phase (the
phase marks add barriers of their own). Prints each K1b kernel's
registers, stack and spills from ``-Xptxas -v``. Runs it at the train
shape of chip_smoke.py (8 x 256² = 524,288 rows, 64 -> 256 -> 256 -> 64,
LayerNorm, tanh GELU, bf16; random inputs from seed 0), with the
pre-activations recomputed and saved; with --f32 the same in the
f32-exact mode (f32 x, g and products). For each it checks the library
build against the plain backward (relative L2 of every gradient within
1e-4 in f32, 1e-2 in bf16) and prints its median time (CUDA events)
beside the instrumented build's, split over the phases in proportion to
their cycles.

``--csrc DIR`` (repeatable) builds DIR/fused_ff_bwd.cu instead of the
package's, DIR holding the headers it includes (a copy of csrc/ with a
design's lines rewritten); the directories are measured in the order
given, so ``--csrc A --csrc B --csrc B --csrc A`` compares two designs in
turns within one process. ``--sass`` also prints, for each K1b kernel
of each directory's library build, the count of its SASS instructions
(``cuobjdump -sass``) and a hash of their text without addresses, so that
two directories' builds of a kernel can be seen to be the same machine
code or not. Prints the card's name and power limit first. Needs CUDA and
nvcc.

``--wide``, instead, runs the package's library build at the factor-4
chains beyond width 256 (320 -> 1280 -> 1280 -> 320 and 512 -> 2048 ->
2048 -> 512, LayerNorm, pre-activations recomputed; their z buffer in
device memory) at 131,072 and 524,288 rows (the train shape's count):
checks it against the plain backward at 131,072 rows, and prints its
median time beside the plain version's there, its tile rows, the scratch
the launcher allocates (the weight-gradient slabs and z buffers of its
blocks) and the rise of the card's peak allocation over the call.
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


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _print_sass(src: str, so: Path, nvcc: str) -> None:
    """Each K1b kernel of the library ``so``: its mangled name, its SASS
    instructions' count and the first 16 hex digits of the SHA-1 of their
    text (addresses and encodings left out)."""
    dump = subprocess.run(
        [str(Path(nvcc).with_name("cuobjdump")), "-sass", str(so)],
        capture_output=True, text=True, check=True, timeout=300).stdout
    for part in dump.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        if "fused_ff_bwd" not in name:
            continue
        ins = re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", part)
        digest = hashlib.sha1("\n".join(i.strip() for i in ins).encode())
        print(f"{src}: sass {name}: {len(ins)} instructions, "
              f"sha1 {digest.hexdigest()[:16]}", flush=True)


def _build_all(srcs: list, out: Path, build, sass: bool = False) -> dict:
    """{(dir, phases): library namespace} for every source directory, the
    builds all started together with the flags of ``build`` (the package's
    _build module); prints each kernel's registers, and with ``sass``
    its SASS (``_print_sass``)."""
    nvcc, flags = build._nvcc(), build.NVCC_FLAGS
    procs = {}
    for i, src in enumerate(srcs):
        for phases in (False, True):
            so = out / f"libk1b_{i}_{'phases' if phases else 'plain'}.so"
            cmd = [nvcc, *flags, *(["-DRPDE_K1B_PHASES"] if phases else []),
                   "-Xptxas", "-v", "-shared", "-o", str(so),
                   str(Path(src) / "fused_ff_bwd.cu")]
            procs[(src, phases)] = (so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    for (src, phases), (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        if not phases:
            # ptxas names each kernel on one line and gives its stack,
            # spills and registers on the next lines
            lines = log.splitlines()
            for i, line in enumerate(lines):
                if "Compiling entry" not in line:
                    continue
                name = next((k for k in ("fused_ff_bwd_f32_kernel",
                                         "fused_ff_bwd_kernel",
                                         "reduce_slabs_kernel")
                             if k in line), None)
                if name is None:
                    continue
                io = "bf16 io" if "I13__nv_bfloat16E" in line else "f32 io"
                info = " | ".join(t.split("ptxas info    :")[-1].strip()
                                  for t in lines[i + 1:i + 4]
                                  if "ptxas info" in t)
                print(f"{src}: {name} ({io}): {info}", flush=True)
            if sass:
                _print_sass(src, so, nvcc)
        lib = ctypes.CDLL(str(so))
        fns = {}
        for fn_name in ("rpde_fused_ff_backward",
                        "rpde_fused_ff_backward_slab"):
            fn = getattr(lib, fn_name)
            fn.argtypes = build._SIGNATURES[fn_name]
            fn.restype = ctypes.c_int
            fns[fn_name] = fn
        if phases:
            counters = lib.rpde_k1b_phase_cycles
            counters.argtypes = [ctypes.c_void_p, ctypes.c_int]
            counters.restype = ctypes.c_int
            fns["counters"] = counters
        libs[(src, phases)] = types.SimpleNamespace(**fns)
    return libs


def wide_chains(f32: bool) -> int:
    """K1b at the factor-4 chains of widths 320 and 512 (``--wide``)."""
    from resolution_pde_tpu_torch.ops.kernels import _build, fused_ff

    gen = torch.Generator().manual_seed(0)
    dtype = torch.float32 if f32 else torch.bfloat16
    tol = 1e-4 if f32 else 1e-2
    kw = dict(approx_gelu=True, compute_dtype=dtype)
    flat = lambda r: [r[0], *r[1], *r[2], *r[3]]  # noqa: E731
    slots = 2 * torch.cuda.get_device_properties(0).multi_processor_count

    def randn(shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen) * scale).to("cuda", dtype)

    for width in (320, 512):
        dims = [width, 4 * width, 4 * width, width]
        ks = [randn((a, b), a ** -0.5) for a, b in zip(dims, dims[1:])]
        bs = [randn((d,), 0.1) for d in dims[1:]]
        ln = (1.0 + randn((width,), 0.1), randn((width,), 0.1))
        tile = fused_ff.backward_tile_rows(dims, True, dtype)
        slab = _build.library().rpde_fused_ff_backward_slab(
            int(not f32), (ctypes.c_int * 4)(*dims), 3, 1)
        for n in (131072, 524288):
            x = randn((n, width), dtype=dtype)
            g = randn((n, width), dtype=dtype)

            def run():
                return fused_ff.fused_feedforward_bwd(x, g, ks, bs, ln, **kw)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            got = flat(run())
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            ms = _time_ms(run, reps=3)
            scratch = min(slots, -(-n // tile)) * slab * 4
            line = (f"K1b {str(dtype)[6:]} {dims} x {n} rows: tile rows "
                    f"{tile}, kernel {ms:.3f} ms, scratch "
                    f"{scratch / 2 ** 30:.3f} GiB, peak allocation rise "
                    f"{peak / 2 ** 30:.3f} GiB")
            if n == 131072:
                def plain():
                    return fused_ff.fused_feedforward_bwd_reference(
                        x, g, ks, bs, ln, **kw)
                err = max(_rel_l2(a, b) for a, b in zip(got, flat(plain())))
                if not err <= tol:
                    raise RuntimeError(f"{dims} x {n}: rel_l2 {err} > {tol}")
                line += (f", plain {_time_ms(plain, reps=3):.3f} ms, rel_l2 "
                         f"{err:.3e} (tol {tol})")
            print(line, flush=True)
            del x, g, got
            torch.cuda.empty_cache()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/k1b_phases")
    ap.add_argument("--f32", action="store_true",
                    help="the f32-exact mode instead of bf16")
    ap.add_argument("--csrc", action="append", default=None,
                    help="a directory holding fused_ff_bwd.cu and its "
                         "headers (default: the package's csrc); "
                         "repeatable, measured in the order given")
    ap.add_argument("--sass", action="store_true",
                    help="print each K1b kernel's SASS count and hash")
    ap.add_argument("--wide", action="store_true",
                    help="the factor-4 chains at widths 320 and 512 at "
                         "realistic row counts")
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

    if args.wide:
        return wide_chains(args.f32)
    order = args.csrc or [str(_build.CSRC)]
    srcs = list(dict.fromkeys(order))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    libs = _build_all(srcs, out, _build, args.sass)
    library = _build.library

    gen = torch.Generator().manual_seed(0)

    def randn(shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen) * scale).to("cuda", dtype)

    n, dims = 8 * 256 * 256, [64, 256, 256, 64]
    ks = [randn((a, b), a ** -0.5) for a, b in zip(dims, dims[1:])]
    bs = [randn((d,), 0.1) for d in dims[1:]]
    ln = (1.0 + randn((dims[-1],), 0.1), randn((dims[-1],), 0.1))
    dtype = torch.float32 if args.f32 else torch.bfloat16
    tol = 1e-4 if args.f32 else 1e-2
    x = randn((n, dims[0]), dtype=dtype)
    g = randn((n, dims[-1]), dtype=dtype)
    kw = dict(approx_gelu=True, compute_dtype=dtype)
    _, zs = fused_ff.fused_feedforward_fwd(x, ks, bs, ln, save_acts=True, **kw)
    _, zs_ref = fused_ff.fused_feedforward_reference(x, ks, bs, ln,
                                                     save_acts=True, **kw)
    flat = lambda r: [r[0], *r[1], *r[2], *r[3]]  # noqa: E731
    refs = {label: flat(fused_ff.fused_feedforward_bwd_reference(
        x, g, ks, bs, ln, zs_saved=z, **kw))
        for label, z in (("recompute", None), ("saved", zs_ref))}
    names = _phase_names(len(ks))
    try:
        for src in order:
            for label, z in (("recompute", None), ("saved", zs)):
                def run():
                    return fused_ff.fused_feedforward_bwd(
                        x, g, ks, bs, ln, zs_saved=z, **kw)
                _build.library = lambda: libs[(src, False)]
                err = max(_rel_l2(a, b) for a, b in zip(flat(run()),
                                                         refs[label]))
                if not err <= tol:
                    raise RuntimeError(f"{src} {label}: rel_l2 {err} > {tol}")
                plain_ms = _time_ms(run)
                phased = libs[(src, True)]
                _build.library = lambda: phased
                run()
                torch.cuda.synchronize()
                _build.check(phased.counters(None, 1), "rpde_k1b_phase_cycles")
                ms = _time_ms(run)
                cycles = (ctypes.c_ulonglong * N_PHASES)()
                _build.check(phased.counters(cycles, 0),
                             "rpde_k1b_phase_cycles")
                total = sum(cycles)
                split = {names.get(i, str(i)): round(c / total * ms, 4)
                         for i, c in enumerate(cycles) if c}
                print(f"{src}: K1b {label} {str(dtype)[6:]}: rel_l2 "
                      f"{err:.3e}, kernel {plain_ms:.4f} ms, with phase "
                      f"marks {ms:.4f} ms; by phase (ms): {split}",
                      flush=True)
    finally:
        _build.library = library
    return 0


if __name__ == "__main__":
    sys.exit(main())
