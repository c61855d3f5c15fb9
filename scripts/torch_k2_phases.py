#!/usr/bin/env python3
"""Device time of the fused spectral axis pass (K2, bf16) by phase, on one GPU.

    python3 scripts/torch_k2_phases.py [--out build/k2_phases]

Builds csrc/spectral_mix.cu alone five times, all nvcc runs started
together, with ``-Xptxas -v`` (each build's registers, stack and spills for
its tensor-core kernel, bf16 x and out, are printed):
  - as the library builds it;
  - with RPDE_K2_PHASES, which makes thread 0 of every block add the clock
    cycles of each phase into a counter (staging x, the forward DFT,
    waiting for a weight slice, starting a weight slice's copy, the mix,
    the inverse DFT's products, its stores);
  - three ablations, copies of the source with a few lines rewritten,
    timed but wrong by design, which say where the time goes: the mix's
    loads without its products, no mix, no weight copies.
Runs each at the train shape of chip_smoke.py (8 x 256² x 64 along W,
m = 64, bf16; random inputs from seed 0): the pass (and with the library
build also its adjoint and the H pass added into acc), each but the
ablations checked against the plain version (relative L2, tolerance 1e-2:
bf16 rounding flips). Times the builds' passes in turns, five rounds of
10 calls, and keeps each build's median (CUDA events); prints them, the
instrumented kernel's split over the phases in proportion to their
cycles, and the plain versions' times. Then the library build at the
FFNO predict's smaller buckets, 8 x 64² and 8 x 128² (m = 33 and 64):
the W pass and the H pass added into acc, each checked and timed beside
its plain version, and their sum over the model's 4 layers, the device
time the spectral passes take in one predict. Prints the card's name and
power limit first. Needs CUDA and nvcc.
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

PHASES = ["staging_x", "forward_dft", "wait_for_weight_mode",
          "start_weight_copy", "mix", "inverse_dft", "stores"]
# ablations, timed only (their results are wrong): the mix's loads without
# its products (nor the waits on their operands); no mix at all; the
# weight slices' barriers without copies. Each: (text in
# csrc/spectral_mix.cu, its replacement)
_MIX_MMA = ("      if (kt % 2)\n"
            "        mma_bf16_16816(odd[h], a, b[h][kt]);\n"
            "      else\n"
            "        mma_bf16_16816(acc[h][0], a, b[h][kt]);")
_MIX_CALL = ("    if (full_mix)\n"
             "      mix_modes_full(p, stage_buf(p, i % kStages), (i - tr) * kSliceModes, macc);\n"
             "    else\n"
             "      mix_modes(p, stage_buf(p, i % kStages), (i - tr) * kSliceModes, macc);")
ABLATIONS = {
    "mix_without_products": [(
        _MIX_MMA,
        '      asm volatile("" ::"r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), '
        '"r"(b[h][kt][0]), "r"(b[h][kt][1]));')],
    "no_mix": [(_MIX_CALL, "    macc[0][0][0] = 0.f;")],
    "no_weight_copies": [
        ("  mbarrier_arrive_expect_tx(stage_bar(p, s), bytes);",
         "  mbarrier_arrive_expect_tx(stage_bar(p, s), 0);"),
        ("  bulk_copy_to_shared(stage_buf(p, s),",
         "  if (bytes == 0) bulk_copy_to_shared(stage_buf(p, s),")],
}


def _time_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
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


def _build_all(out: Path) -> dict:
    """The builds of spectral_mix.cu, each loaded: name -> CDLL."""
    from resolution_pde_tpu_torch.ops.kernels import _build

    src = _build.CSRC / "spectral_mix.cu"
    builds = {"library": (src, []), "phases": (src, ["-DRPDE_K2_PHASES"])}
    for name, edits in ABLATIONS.items():
        text = src.read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"spectral_mix.cu no longer holds {old!r}")
            text = text.replace(old, new)
        path = out / f"spectral_mix_{name}.cu"
        path.write_text(text)
        builds[name] = (path, [])
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-I", str(_build.CSRC),
         "-Xptxas", "-v", "-shared", "-o", str(out / f"libk2_{name}.so"),
         str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name, (path, flags) in builds.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        # ptxas names each kernel on one line and gives its stack, spills
        # and registers on the next two
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if ("Compiling entry" in line and "spectral_pass_mma_kernel" in line
                    and "I13__nv_bfloat16E" in line):
                info = " | ".join(t.split("ptxas info    :")[-1].strip()
                                  for t in lines[i + 2:i + 4])
                print(f"{name}: {info}", flush=True)
        libs[name] = ctypes.CDLL(str(out / f"libk2_{name}.so"))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/k2_phases")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k2_phases: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    from resolution_pde_tpu_torch.ops.kernels import _build
    from resolution_pde_tpu_torch.ops.kernels import spectral_mix as sm

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name, so in _build_all(out).items():
        fn = so.rpde_spectral_pass
        fn.argtypes = _build._SIGNATURES["rpde_spectral_pass"]
        fn.restype = ctypes.c_int
        libs[name] = types.SimpleNamespace(rpde_spectral_pass=fn)
        if name == "phases":
            counters = so.rpde_k2_phase_cycles
            counters.argtypes = [ctypes.c_void_p, ctypes.c_int]
            counters.restype = ctypes.c_int

    gen = torch.Generator().manual_seed(0)

    def randn(shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen) * scale).to("cuda", dtype)

    bf = torch.bfloat16
    cuda = torch.device("cuda")

    def pass_cases(batch, res, width, modes):
        """name -> (kernel call, plain call, acc buffer and its start or
        None) at one shape: the W pass, the H pass added into acc, the W
        pass's adjoint."""
        m = min(modes, res // 2 + 1)
        x = randn((batch, res, res, width), dtype=bf)
        acc0 = randn((batch, res, res, width), dtype=bf)
        wab = sm.mix_blocks(randn((width, width, modes, 2), 0.1), m)
        wpk = sm.pack_blocks(wab)
        fwd = sm.packed_factors(res, m, "ortho", cuda)
        adj = sm.adjoint_factors(res, m, "ortho", cuda)
        buf = acc0.clone()
        return {
            "w_pass": (lambda: sm.spectral_axis_pass(x, wab, 2, "ortho", bf),
                       lambda: sm._plain_axis_pass(x, *fwd, wpk, 2, bf, None),
                       None),
            "h_pass_acc": (
                lambda: sm.spectral_axis_pass(x, wab, 1, "ortho", bf,
                                              acc=buf),
                lambda: sm._plain_axis_pass(x, *fwd, wpk, 1, bf, buf),
                (buf, acc0)),
            "w_adjoint": (
                lambda: sm.spectral_axis_adjoint(x, wab, 2, "ortho", bf),
                lambda: sm._plain_axis_pass(x, *adj, wpk.transpose(1, 2), 2,
                                            bf, None),
                None),
        }

    def check(case, name):
        run, plain, acc = case
        if acc is not None:
            acc[0].copy_(acc[1])
            got = run().clone()
            acc[0].copy_(acc[1])
            want = plain().clone()
        else:
            got, want = run(), plain()
        err = _rel_l2(got, want)
        torch.cuda.synchronize()
        if not err <= 1e-2:
            raise AssertionError(f"{name}: rel_l2 {err} against the plain "
                                 "version")
        return err

    res, width, modes = 256, 64, 64
    cases = pass_cases(8, res, width, modes)

    lib = _build.library
    ms = {}
    names = ("library", *ABLATIONS, "phases")
    try:
        for name in names:
            _build.library = lambda name=name: libs[name]
            for case in list(cases) if name == "library" else ["w_pass"]:
                if name not in ABLATIONS:
                    err = check(cases[case], case)
                    print(f"{name} {case}: rel_l2 {err:.3e} (tol 1e-2)",
                          flush=True)
        # the pass, every build in turn, 5 rounds of 10 timed calls; each
        # build's median over the rounds
        _build.library = lambda: libs["phases"]
        _build.check(counters(None, 1), "rpde_k2_phase_cycles")
        rounds = {name: [] for name in names}
        for _ in range(5):
            for name in names:
                _build.library = lambda name=name: libs[name]
                rounds[name].append(_time_ms(cases["w_pass"][0], reps=10))
        for name in names:
            ms[name, "w_pass"] = statistics.median(rounds[name])
        cycles = (ctypes.c_ulonglong * len(PHASES))()
        _build.check(counters(cycles, 0), "rpde_k2_phase_cycles")
        _build.library = lambda: libs["library"]
        for case in ("h_pass_acc", "w_adjoint"):
            ms["library", case] = _time_ms(cases[case][0])
        # the predict's smaller buckets: the W pass and the H pass with acc
        small = {}
        for r in (64, 128):
            sc = pass_cases(8, r, width, modes)
            for case in ("w_pass", "h_pass_acc"):
                err = check(sc[case], f"8x{r}^2 {case}")
                small[r, case] = (err, _time_ms(sc[case][0]),
                                  _time_ms(sc[case][1], reps=5))
    finally:
        _build.library = lib
    for (name, case), t in ms.items():
        print(f"{name} {case}: {t:.4f} ms", flush=True)
    for case in cases:
        print(f"plain {case}: {_time_ms(cases[case][1], reps=5):.4f} ms",
              flush=True)
    total = sum(cycles)
    split = {p: round(c / total * ms["phases", "w_pass"], 4)
             for p, c in zip(PHASES, cycles)}
    gflop = 2.0 * 8 * res * (width * res * 2 * modes
                             + modes * 4 * width * width
                             + width * 2 * modes * res) / 1e9
    ablations = ", ".join(f"{d} {ms[d, 'w_pass']:.4f} ms" for d in ABLATIONS)
    print(f"K2 bf16 W pass: {ms['library', 'w_pass']:.4f} ms "
          f"({gflop / ms['library', 'w_pass']:.1f} TFLOP/s); {ablations}; "
          f"with phase marks {ms['phases', 'w_pass']:.4f} ms; by phase (ms): "
          f"{split}", flush=True)
    for r in (64, 128):
        for case in ("w_pass", "h_pass_acc"):
            err, t, tp = small[r, case]
            print(f"8x{r}^2 {case}: {t:.4f} ms (plain {tp:.4f} ms), rel_l2 "
                  f"{err:.3e} (tol 1e-2)", flush=True)
        per_predict = 4 * (small[r, "w_pass"][1] + small[r, "h_pass_acc"][1])
        print(f"8x{r}^2: the spectral passes of one predict (4 layers, W "
              f"and H) {per_predict:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
