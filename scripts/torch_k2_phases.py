#!/usr/bin/env python3
"""Device time of the fused spectral axis pass by phase, on one GPU: K2
(bf16 products on the tensor cores) or, with ``--f32``, K3 (the f32-exact
pass, IEEE f32 products on the CUDA cores).

    python3 scripts/torch_k2_phases.py [--f32] [--out build/k2_phases]
    python3 scripts/torch_k2_phases.py --e2e-root DIR [--e2e-root DIR ...]

Builds csrc/spectral_mix.cu alone several times, all nvcc runs started
together, with ``-Xptxas -v`` (each build's registers, stack and spills
for the kernel under study are printed):
  - as the library builds it;
  - with RPDE_K2_PHASES (RPDE_K3_PHASES with --f32), which makes thread 0
    of every block add the clock cycles of each phase into a counter (K2:
    staging x, the forward DFT, waiting for a weight slice, starting a
    weight slice's copy, the mix, the inverse DFT's products, its stores;
    K3: waiting for a DFT slice and starting the next, the forward DFT's
    products and stores, the mix, the inverse DFT's products and stores);
  - ablations, copies of the source with a few lines rewritten, timed but
    wrong by design, which say where the time goes (K2: the mix's loads
    without its products, no mix, no weight copies; K3: no mix, the mix
    with its weights made in registers instead of loaded).
Runs each at the train shape of chip_smoke.py (8 x 256² x 64 along W,
m = 64; random inputs from seed 0): the pass (and with the library build
also the H pass added into acc and both adjoints), each but the ablations
checked against the plain version (relative L2, tolerance 1e-2 in bf16,
where rounding flips move an element by one bf16 ulp; 1e-4 in f32, where
only the order of the sums differs); with --f32 also the library's pass
twice for the same bits. Times the builds' passes in turns, five rounds of
10 calls, and keeps each build's median (CUDA events); prints them, the
instrumented kernel's split over the phases in proportion to their
cycles, and the plain versions' times. Then the library build at the FFNO
predict's smaller buckets, 8 x 64² and 8 x 128² (m = 33 and 64): the W
pass and the H pass added into acc, each checked and timed beside its
plain version, and their sum over the model's 4 layers, the device time
the spectral passes take in one predict.

With ``--e2e-root``, instead, for the package in each DIR in the order
given (a checkout of this repository; its kernels build into DIR/build):
the f32-exact FFNO2D predict at 8 x 256² (median of 10), the median of 5
f32-exact train steps at 8 x 256² (after 2) and the median of 10 bf16
train steps there (after 3), bench.py's width, random weights from seed
0; one JSON line each, so that two trees are compared in one call. Prints the card's name and power limit first. Needs CUDA and
nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

# ablations, timed only (their results are wrong). Each: (text in
# csrc/spectral_mix.cu, its replacement)
_MIX_MMA = ("      if (kt % 2)\n"
            "        mma_bf16_16816(odd[h], a, b[h][kt]);\n"
            "      else\n"
            "        mma_bf16_16816(acc[h][0], a, b[h][kt]);")
_MIX_CALL = ("    if (full_mix)\n"
             "      mix_modes_full(p, stage_buf(p, i % kStages), (i - tr) * kSliceModes, macc);\n"
             "    else\n"
             "      mix_modes(p, stage_buf(p, i % kStages), (i - tr) * kSliceModes, macc);")
_K3_LOADS = ("      for (int u = 0; u < kC; ++u) ldg_vec(w[s][u], src + (s * p.c8 + u) "
             "* p.o8);")

# per kernel: its compute dtype, tolerance, phase flag and counters, phase
# names, ablations, and the test naming its kernel on a ptxas line
KERNELS = {
    "K2": dict(
        dtype=torch.bfloat16, tol=1e-2, define="-DRPDE_K2_PHASES",
        counters="rpde_k2_phase_cycles",
        phases=["staging_x", "forward_dft", "wait_for_weight_mode",
                "start_weight_copy", "mix", "inverse_dft", "stores"],
        ablations={
            # the mix's loads without its products (nor the waits on their
            # operands); no mix at all; the weight slices' barriers without
            # copies
            "mix_without_products": [(
                _MIX_MMA,
                '      asm volatile("" ::"r"(a[0]), "r"(a[1]), "r"(a[2]), '
                '"r"(a[3]), "r"(b[h][kt][0]), "r"(b[h][kt][1]));')],
            "no_mix": [(_MIX_CALL, "    macc[0][0][0] = 0.f;")],
            "no_weight_copies": [
                ("  mbarrier_arrive_expect_tx(stage_bar(p, s), bytes);",
                 "  mbarrier_arrive_expect_tx(stage_bar(p, s), 0);"),
                ("  bulk_copy_to_shared(stage_buf(p, s),",
                 "  if (bytes == 0) bulk_copy_to_shared(stage_buf(p, s),")],
        },
        ptxas=lambda line: ("spectral_pass_mma_kernel" in line
                            and "I13__nv_bfloat16E" in line)),
    "K3": dict(
        dtype=torch.float32, tol=1e-4, define="-DRPDE_K3_PHASES",
        counters="rpde_k3_phase_cycles",
        phases=["wait_and_start", "forward_dft", "spectrum_stores", "mix",
                "inverse_dft", "stores"],
        ablations={
            # no mix at all; the mix with its weights made in registers
            "no_mix": [("  mix_warp<TR, kBf16>(p, spec, wk);\n", "  ;\n")],
            "no_weight_loads": [(
                _K3_LOADS,
                "      for (int u = 0; u < kC; ++u)\n"
                "        for (int e = 0; e < kE; ++e) w[s][u][e] = "
                "0.5f * u + 0.25f * (s + k + q + e);")],
        },
        # the f32 instantiations (kBf16 false)
        ptxas=lambda line: ("spectral_pass_kernel" in line
                            and "mma" not in line and "Lb0E" in line)),
}


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


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


def _build_all(out: Path, kernel: dict) -> dict:
    """The builds of spectral_mix.cu, each loaded: name -> CDLL."""
    from resolution_pde_tpu_torch.ops.kernels import _build

    src = _build.CSRC / "spectral_mix.cu"
    builds = {"library": (src, []), "phases": (src, [kernel["define"]])}
    for name, edits in kernel["ablations"].items():
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
         "-Xptxas", "-v", "-shared", "-o", str(out / f"lib_{name}.so"),
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
            if "Compiling entry" in line and kernel["ptxas"](line):
                io = "bf16" if "nv_bfloat16" in line else "f32"
                tile = re.search(r"ELi(\d+)E", line)
                what = f"{io} io" + (f", {tile.group(1)} rows" if tile else "")
                info = " | ".join(t.split("ptxas info    :")[-1].strip()
                                  for t in lines[i + 2:i + 4])
                print(f"{name} ({what}): {info}", flush=True)
        libs[name] = ctypes.CDLL(str(out / f"lib_{name}.so"))
    return libs


def phases(out: Path, which: str) -> int:
    from resolution_pde_tpu_torch.ops.kernels import _build
    from resolution_pde_tpu_torch.ops.kernels import spectral_mix as sm

    kernel = KERNELS[which]
    cd, tol, ablations = kernel["dtype"], kernel["tol"], kernel["ablations"]
    out.mkdir(parents=True, exist_ok=True)
    libs = {}
    counters = None
    for name, so in _build_all(out, kernel).items():
        fn = so.rpde_spectral_pass
        fn.argtypes = _build._SIGNATURES["rpde_spectral_pass"]
        fn.restype = ctypes.c_int
        libs[name] = types.SimpleNamespace(rpde_spectral_pass=fn)
        if name == "phases":
            counters = getattr(so, kernel["counters"])
            counters.argtypes = [ctypes.c_void_p, ctypes.c_int]
            counters.restype = ctypes.c_int

    gen = torch.Generator().manual_seed(0)

    def randn(shape, scale=1.0, dtype=cd):
        return (torch.randn(shape, generator=gen) * scale).to("cuda", dtype)

    cuda = torch.device("cuda")

    def pass_cases(batch, res, width, modes):
        """name -> (kernel call, plain call, acc buffer and its start or
        None) at one shape: the W pass, the H pass added into acc, the W
        pass's adjoint and the H adjoint added into acc."""
        m = min(modes, res // 2 + 1)
        x = randn((batch, res, res, width))
        acc0 = randn((batch, res, res, width))
        wab = sm.mix_blocks(randn((width, width, modes, 2), 0.1,
                                  torch.float32), m)
        wpk = sm.pack_blocks(wab)
        fwd = sm.packed_factors(res, m, "ortho", cuda)
        adj = sm.adjoint_factors(res, m, "ortho", cuda)
        buf, abuf = acc0.clone(), acc0.clone()
        return {
            "w_pass": (lambda: sm.spectral_axis_pass(x, wab, 2, "ortho", cd),
                       lambda: sm._plain_axis_pass(x, *fwd, wpk, 2, cd, None),
                       None),
            "h_pass_acc": (
                lambda: sm.spectral_axis_pass(x, wab, 1, "ortho", cd,
                                              acc=buf),
                lambda: sm._plain_axis_pass(x, *fwd, wpk, 1, cd, buf),
                (buf, acc0)),
            "w_adjoint": (
                lambda: sm.spectral_axis_adjoint(x, wab, 2, "ortho", cd),
                lambda: sm._plain_axis_pass(x, *adj, wpk.transpose(1, 2), 2,
                                            cd, None),
                None),
            "h_adjoint_acc": (
                lambda: sm.spectral_axis_adjoint(x, wab, 1, "ortho", cd,
                                                 acc=abuf),
                lambda: sm._plain_axis_pass(x, *adj, wpk.transpose(1, 2), 1,
                                            cd, abuf),
                (abuf, acc0)),
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
        if not err <= tol:
            raise AssertionError(f"{name}: rel_l2 {err} against the plain "
                                 "version")
        return err

    res, width, modes = 256, 64, 64
    cases = pass_cases(8, res, width, modes)
    lib = _build.library
    names = ("library", *ablations, "phases")
    ms = {}
    try:
        for name in names:
            _build.library = lambda name=name: libs[name]
            for case in list(cases) if name == "library" else ["w_pass"]:
                if name not in ablations:
                    err = check(cases[case], case)
                    print(f"{name} {case}: rel_l2 {err:.3e} (tol {tol})",
                          flush=True)
        _build.library = lambda: libs["library"]
        if which == "K3":
            first = cases["w_pass"][0]().clone()
            again = cases["w_pass"][0]()
            torch.cuda.synchronize()
            if not torch.equal(first, again):
                raise AssertionError("two calls on the same inputs differ")
            print("library w_pass: two calls give the same bits", flush=True)
        # the pass, every build in turn, 5 rounds of 10 timed calls; each
        # build's median over the rounds
        _build.library = lambda: libs["phases"]
        _build.check(counters(None, 1), kernel["counters"])
        rounds = {name: [] for name in names}
        for _ in range(5):
            for name in names:
                _build.library = lambda name=name: libs[name]
                rounds[name].append(_time_ms(cases["w_pass"][0], reps=10))
        for name in names:
            ms[name, "w_pass"] = statistics.median(rounds[name])
        cycles = (ctypes.c_ulonglong * len(kernel["phases"]))()
        _build.check(counters(cycles, 0), kernel["counters"])
        _build.library = lambda: libs["library"]
        for case in list(cases)[1:]:
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
             for p, c in zip(kernel["phases"], cycles)}
    # the products the kernel does (its DFTs as dense products)
    gflop = 2.0 * 8 * res * (width * res * 2 * modes
                             + modes * 4 * width * width
                             + width * 2 * modes * res) / 1e9
    others = ", ".join(f"{d} {ms[d, 'w_pass']:.4f} ms" for d in ablations)
    print(f"{which} W pass: {ms['library', 'w_pass']:.4f} ms "
          f"({gflop / ms['library', 'w_pass']:.1f} TFLOP/s of its dense "
          f"products); {others}; with phase marks "
          f"{ms['phases', 'w_pass']:.4f} ms; by phase (ms): {split}",
          flush=True)
    for r in (64, 128):
        for case in ("w_pass", "h_pass_acc"):
            err, t, tp = small[r, case]
            print(f"8x{r}^2 {case}: {t:.4f} ms (plain {tp:.4f} ms), rel_l2 "
                  f"{err:.3e} (tol {tol})", flush=True)
        per_predict = 4 * (small[r, "w_pass"][1] + small[r, "h_pass_acc"][1])
        print(f"8x{r}^2: the spectral passes of one predict (4 layers, W "
              f"and H) {per_predict:.4f} ms", flush=True)
    return 0


def e2e(root: Path) -> dict:
    """The f32-exact predict and train step at 8 x 256² through the package
    in ``root``, in a process of its own."""
    code = f"""
import json, statistics, sys, time
import numpy as np, torch
sys.path.insert(0, {str(root)!r})
torch.backends.cuda.matmul.allow_tf32 = False
from resolution_pde_tpu_torch.deploy import ServingEngine
from resolution_pde_tpu_torch.models import FFNO2D
from resolution_pde_tpu_torch.train import Trainer
import resolution_pde_tpu_torch
def model(bf16=False):
    return FFNO2D(in_channels=1, out_channels=1, width=64, n_layers=4,
                  n_modes=64, factor=4, ff_weight_norm=True, n_ff_layers=3,
                  layer_norm=True, dropout=0.0,
                  compute_dtype=torch.bfloat16 if bf16 else None,
                  spectral_impl="pallas2" if bf16 else "pallas",
                  approx_gelu=True, ff_impl="fused", device="cuda",
                  generator=torch.Generator().manual_seed(0))
rng = np.random.default_rng(0)
x = rng.standard_normal((8, 1, 256, 256)).astype(np.float32)
eng = ServingEngine(model(), device="cuda")
eng.warmup(spatial_shapes=[(256, 256)], batch_sizes=[8])
times = []
for _ in range(10):
    t = time.perf_counter()
    eng.predict(x)
    times.append((time.perf_counter() - t) * 1e3)
trainer = Trainer(model(), learning_rate=1e-3, device="cuda")
state = trainer.init()
xd = torch.from_numpy(x).cuda()
yd = torch.roll(xd, 7, dims=-1)
steps = []
for i in range(7):
    t = time.perf_counter()
    state, loss = trainer.train_step(state, xd, yd)
    torch.cuda.synchronize()
    if i >= 2:
        steps.append((time.perf_counter() - t) * 1e3)
trainer = Trainer(model(bf16=True), learning_rate=1e-3, device="cuda")
state16 = trainer.init()
steps16 = []
for i in range(13):
    t = time.perf_counter()
    state16, loss16 = trainer.train_step(state16, xd, yd)
    torch.cuda.synchronize()
    if i >= 3:
        steps16.append((time.perf_counter() - t) * 1e3)
print(json.dumps(dict(root={str(root)!r},
                      package=resolution_pde_tpu_torch.__file__,
                      predict_ms=statistics.median(times),
                      step_ms=statistics.median(steps), loss=float(loss),
                      bf16_step_ms=statistics.median(steps16),
                      bf16_loss=float(loss16))))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=1200, cwd=str(root))
    if res.returncode != 0:
        raise RuntimeError(f"e2e at {root} failed:\n{res.stdout}\n"
                           f"{res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--f32", action="store_true",
                    help="the f32-exact pass (K3) instead of K2")
    ap.add_argument("--out", default="build/k2_phases")
    ap.add_argument("--e2e-root", action="append", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k2_phases: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(_smi(), flush=True)
    if args.e2e_root:
        for root in args.e2e_root:
            t0 = time.perf_counter()
            rec = e2e(Path(root).resolve())
            rec["seconds"] = round(time.perf_counter() - t0, 1)
            print(json.dumps(rec), flush=True)
        return 0
    sys.path.insert(0, str(ROOT))
    which = "K3" if args.f32 else "K2"
    return phases(Path(args.out) / which.lower(), which)


if __name__ == "__main__":
    sys.exit(main())
