#!/usr/bin/env python3
"""Device time of the spectral axis pass on one GPU: the f32 kernel (K3,
IEEE f32 products on the CUDA cores) by phase; with ``--wide``, the bf16
pass (the staged route) by stage and by design; with ``--wide-root`` or
``--e2e-root``, bf16 passes or whole predicts and steps through the
package of another tree.

    python3 scripts/torch_k2_phases.py [--out build/k2_phases]
    python3 scripts/torch_k2_phases.py --wide [--out build/k2_phases]
    python3 scripts/torch_k2_phases.py --wide-root DIR [--wide-root DIR ...]
    python3 scripts/torch_k2_phases.py --e2e-root DIR [--e2e-root DIR ...]
    python3 scripts/torch_k2_phases.py --predict-root DIR [...]

Builds csrc/spectral_mix.cu alone several times, all nvcc runs started
together, with ``-Xptxas -v`` (each build's registers, stack and spills
for the f32 kernel of each tile size, 4, 2 and 1 rows, are printed):
  - as the library builds it;
  - with RPDE_K3_PHASES, which makes thread 0 of every block add the clock
    cycles of each phase into a counter (waiting for a DFT slice and
    starting the next, the forward DFT's products and stores, the mix, the
    inverse DFT's products and stores);
  - ablations, copies of the source with a few lines rewritten, timed but
    wrong by design, which say where the time goes (no mix; the mix with
    its weights made in registers instead of loaded).
Runs each at the train shape of chip_smoke.py (8 x 256² x 64 along W,
m = 64; random inputs from seed 0): the pass (and with the library build
also the H pass added into acc and both adjoints), each but the ablations
checked against the plain version (relative L2 1e-4: only the order of
the f32 sums differs), and the library's pass twice for the same bits.
Times the builds' passes in turns, five rounds of 10 calls, and keeps
each build's median (CUDA events); prints them, the instrumented kernel's
split over the phases in proportion to their cycles, and the plain
versions' times. Then the library build at the FFNO predict's smaller
buckets, 8 x 64² and 8 x 128² (m = 33 and 64): the W pass and the H pass
added into acc, each checked and timed beside its plain version, and
their sum over the model's 4 layers, the device time the spectral passes
take in one predict.

With ``--wide``, instead: builds csrc/spectral_staged.cu alone, in
parallel, as the library builds it and as copies with a few lines
rewritten: once per stage, the entry launching that stage alone
(``STAGED_ALONE``), and once per other design of its block tile, ring and
stores (``STAGED_DESIGNS``), printing each design's registers, stack and
spills; checks the library build's W pass, H pass with acc and W adjoint
at 128 -> 128 over 8 x 256² (m = 64) and the pass and adjoint at 256 ->
256 on 64 rows against the plain version (relative L2 1e-2) and two
calls for the same bits; then times, in turns (five rounds of 10 calls
of the C entry on operands made once, each build's median), every
build's pass at both shapes, and the library's pass at 128 -> 128 made of
calls over chunks of 256 and 512 rows beside one call over all rows.

With ``--wide-root``, for the package in each DIR in the order given, in
a process each: bf16 passes at 64 -> 64 over 8 x 256² (W, H with acc, and
both adjoints, the H one with acc: the train step's four), at the
predict's 8 x 64² and 8 x 128² (W, H with acc, W adjoint), 128 -> 128
over 8 x 256² (W, H with acc, and the W adjoint) and 256 -> 256 on 64
rows (pass and adjoint), each checked against the plain version
(relative L2 1e-2) and timed (median of 20; CUDA events), one JSON line
each: two trees' routes compared in one call.

With ``--e2e-root``, instead, for the package in each DIR in the order
given (a checkout of this repository; its kernels build into DIR/build):
the f32-exact FFNO2D predict at 8 x 256² (median of 10), the median of 5
f32-exact train steps at 8 x 256² (after 2), the median of 10 bf16 train
steps there (after 3) and of 10 bf16 predicts of 8, bench.py's width,
and the median of 5 bf16 train steps (after 2) and of 5 predicts of 5 at
width 128, random weights from seed 0; one JSON line each, so that two
trees are compared in one call. ``--predict-root DIR`` (repeatable) times
only the bf16 predict there, the median of 30 in a process each, beside
the host time a call of the K1f launcher's planner mirror. Prints the
card's name and power limit first. Needs CUDA and nvcc.
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

# ablations of the f32 kernel, timed only (their results are wrong). Each:
# (text in csrc/spectral_mix.cu, its replacement)
_K3_LOADS = ("      for (int u = 0; u < kC; ++u) ldg_vec(w[s][u], src + (s * p.c8 + u) "
             "* p.o8);")
K3_ABLATIONS = {
    # no mix at all; the mix with its weights made in registers
    "no_mix": [("  mix_warp<TR>(p, spec, wk);\n", "  ;\n")],
    "no_weight_loads": [(
        _K3_LOADS,
        "      for (int u = 0; u < kC; ++u)\n"
        "        for (int e = 0; e < kE; ++e) w[s][u][e] = "
        "0.5f * u + 0.25f * (s + k + q + e);")],
}
K3_PHASES = ["wait_and_start", "forward_dft", "spectrum_stores", "mix",
             "inverse_dft", "stores"]

# the staged route's other designs and its stages alone: copies of
# csrc/spectral_staged.cu with these lines rewritten (its own design: 128 x
# 128 tiles, 64-deep slices, a ring of 3, the epilogues' 16-byte stores
# through shared memory)
_LAUNCH_MIX = "  staged_mix_kernel<<<"
_LAUNCH_INV = "  inv<<<"
_LAUNCH_FWD = "  fwd<<<"
STAGED_DESIGNS = {
    "bn64": [("constexpr int kBN = 128;", "constexpr int kBN = 64;")],
    "bk32": [("constexpr int kBK = 64;", "constexpr int kBK = 32;")],
    "ring2": [("constexpr int kRing = 3;", "constexpr int kRing = 2;")],
    "ring4": [("constexpr int kRing = 3;", "constexpr int kRing = 4;")],
    # every epilogue stores from its fragments, 4 or 8 bytes a lane
    "fragment_stores": [("  if (op.pieces()) {", "  if (false && op.pieces()) {")],
}
STAGED_ALONE = {
    f"stage{k}": [(line, line.replace("  ", "  if (false) ", 1))
                  for line in (_LAUNCH_FWD, _LAUNCH_MIX, _LAUNCH_INV)
                  if line != keep]
    for k, keep in ((1, _LAUNCH_FWD), (2, _LAUNCH_MIX), (3, _LAUNCH_INV))}

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


def _calls_ms(so, calls_args: list, calls: int = 10) -> float:
    """Device time of one pass made of the staged route's C entry of ``so``
    called once with each of ``calls_args``: ``calls`` passes between two
    CUDA events (after a warm pass)."""
    from resolution_pde_tpu_torch.ops.kernels import _build

    for args in calls_args:
        _build.check(so.rpde_spectral_staged(*args), "rpde_spectral_staged")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        for args in calls_args:
            so.rpde_spectral_staged(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def _rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _build_all(out: Path) -> dict:
    """The builds of spectral_mix.cu, each loaded: name -> CDLL."""
    from resolution_pde_tpu_torch.ops.kernels import _build

    src = _build.CSRC / "spectral_mix.cu"
    builds = {"library": (src, []), "phases": (src, ["-DRPDE_K3_PHASES"])}
    for name, edits in K3_ABLATIONS.items():
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
            if "Compiling entry" in line and "spectral_pass_kernel" in line:
                io = "bf16" if "nv_bfloat16" in line else "f32"
                tile = re.search(r"ELi(\d+)E", line)
                what = f"{io} io" + (f", {tile.group(1)} rows" if tile else "")
                info = " | ".join(t.split("ptxas info    :")[-1].strip()
                                  for t in lines[i + 2:i + 4])
                print(f"{name} ({what}): {info}", flush=True)
        libs[name] = ctypes.CDLL(str(out / f"lib_{name}.so"))
    return libs


def phases(out: Path) -> int:
    """The f32 kernel (K3) by phase and ablation (the default mode)."""
    from resolution_pde_tpu_torch.ops.kernels import _build
    from resolution_pde_tpu_torch.ops.kernels import spectral_mix as sm

    cd, tol, ablations = torch.float32, 1e-4, K3_ABLATIONS
    out.mkdir(parents=True, exist_ok=True)
    libs = {}
    counters = None
    for name, so in _build_all(out).items():
        fn = so.rpde_spectral_pass
        fn.argtypes = _build._SIGNATURES["rpde_spectral_pass"]
        fn.restype = ctypes.c_int
        libs[name] = types.SimpleNamespace(rpde_spectral_pass=fn)
        if name == "phases":
            counters = so.rpde_k3_phase_cycles
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
        first = cases["w_pass"][0]().clone()
        again = cases["w_pass"][0]()
        torch.cuda.synchronize()
        if not torch.equal(first, again):
            raise AssertionError("two calls on the same inputs differ")
        print("library w_pass: two calls give the same bits", flush=True)
        # the pass, every build in turn, 5 rounds of 10 timed calls; each
        # build's median over the rounds
        _build.library = lambda: libs["phases"]
        _build.check(counters(None, 1), "rpde_k3_phase_cycles")
        rounds = {name: [] for name in names}
        for _ in range(5):
            for name in names:
                _build.library = lambda name=name: libs[name]
                rounds[name].append(_time_ms(cases["w_pass"][0], reps=10))
        for name in names:
            ms[name, "w_pass"] = statistics.median(rounds[name])
        cycles = (ctypes.c_ulonglong * len(K3_PHASES))()
        _build.check(counters(cycles, 0), "rpde_k3_phase_cycles")
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
             for p, c in zip(K3_PHASES, cycles)}
    # the products the kernel does (its DFTs as dense products)
    gflop = 2.0 * 8 * res * (width * res * 2 * modes
                             + modes * 4 * width * width
                             + width * 2 * modes * res) / 1e9
    others = ", ".join(f"{d} {ms[d, 'w_pass']:.4f} ms" for d in ablations)
    print(f"K3 W pass: {ms['library', 'w_pass']:.4f} ms "
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


def _build_staged(out: Path) -> dict:
    """The builds of spectral_staged.cu, each loaded: name -> namespace
    with its rpde_spectral_staged. The library's source as it is, and
    copies with the lines of ``STAGED_DESIGNS`` and ``STAGED_ALONE``
    rewritten."""
    from resolution_pde_tpu_torch.ops.kernels import _build

    src = _build.CSRC / "spectral_staged.cu"
    builds = {"library": src}
    for name, edits in {**STAGED_ALONE, **STAGED_DESIGNS}.items():
        text = src.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"spectral_staged.cu holds {old!r} "
                                   f"{text.count(old)} times, not once")
            text = text.replace(old, new)
        path = out / f"spectral_staged_{name}.cu"
        path.write_text(text)
        builds[name] = path
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
         "-Xptxas", "-v", "-shared", "-o", str(out / f"lib_{name}.so"),
         str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name, path in builds.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            found = re.search(r"staged_(forward|mix|inverse)_kernel", line)
            if "Compiling entry" in line and found:
                kernel = found.group(0)
                io = ("" if "mix" in kernel else " (bf16 io)"
                      if "I13__nv_bfloat16E" in line else " (f32 io)")
                info = " | ".join(t.split("ptxas info    :")[-1].strip()
                                  for t in lines[i + 2:i + 4])
                if name not in STAGED_ALONE:
                    print(f"{name} {kernel}{io}: {info}", flush=True)
        fn = ctypes.CDLL(str(out / f"lib_{name}.so")).rpde_spectral_staged
        fn.argtypes = _build._SIGNATURES["rpde_spectral_staged"]
        fn.restype = ctypes.c_int
        libs[name] = types.SimpleNamespace(rpde_spectral_staged=fn)
    return libs


def _check_cases(cases: dict, what: str) -> None:
    """Each case's call against its plain version (relative L2 1e-2)."""
    for case, (run, plain, acc) in cases.items():
        if acc is not None:
            acc[0].copy_(acc[1])
            got = run().clone()
            acc[0].copy_(acc[1])
            want = plain().clone()
        else:
            got, want = run(), plain()
        err = _rel_l2(got, want)
        print(f"{what} {case}: rel_l2 {err:.3e} (tol 1e-2)", flush=True)
        if not err <= 1e-2:
            raise AssertionError(f"{what} {case}: rel_l2 {err}")


def wide(out: Path) -> int:
    """The staged route by stage and by design (``--wide``)."""
    from resolution_pde_tpu_torch.ops.kernels import _build
    from resolution_pde_tpu_torch.ops.kernels import spectral_mix as sm

    out.mkdir(parents=True, exist_ok=True)
    libs = _build_staged(out)
    gen = torch.Generator().manual_seed(0)
    cd, cuda = torch.bfloat16, torch.device("cuda")

    def randn(shape, scale=1.0, dtype=cd):
        return (torch.randn(shape, generator=gen) * scale).to("cuda", dtype)

    def shape_cases(batch, rows, res, width, adjoints=False):
        """The W pass, the W adjoint and, where H is the W axis's length,
        the H pass added into acc (and with ``adjoints`` the H adjoint
        added into acc)."""
        m = min(64, res // 2 + 1)
        x = randn((batch, rows, res, width))
        acc0 = randn((batch, rows, res, width))
        wab = sm.mix_blocks(randn((width, width, 64, 2), 0.1,
                                  torch.float32), m)
        wpk = sm.pack_blocks(wab)
        fwd = sm.packed_factors(res, m, "ortho", cuda)
        adj = sm.adjoint_factors(res, m, "ortho", cuda)
        buf, abuf = acc0.clone(), acc0.clone()
        cases = {
            "w_pass": (lambda: sm.spectral_axis_pass(x, wab, 2, "ortho", cd),
                       lambda: sm._plain_axis_pass(x, *fwd, wpk, 2, cd, None),
                       None),
            "w_adjoint": (
                lambda: sm.spectral_axis_adjoint(x, wab, 2, "ortho", cd),
                lambda: sm._plain_axis_pass(x, *adj, wpk.transpose(1, 2), 2,
                                            cd, None),
                None),
        }
        if rows == res:
            cases["h_pass_acc"] = (
                lambda: sm.spectral_axis_pass(x, wab, 1, "ortho", cd,
                                              acc=buf),
                lambda: sm._plain_axis_pass(x, *fwd, wpk, 1, cd, buf),
                (buf, acc0))
        if adjoints:
            cases["h_adjoint_acc"] = (
                lambda: sm.spectral_axis_adjoint(x, wab, 1, "ortho", cd,
                                                 acc=abuf),
                lambda: sm._plain_axis_pass(x, *adj, wpk.transpose(1, 2), 1,
                                            cd, abuf),
                (abuf, acc0))
        return cases

    def direct_call(batch, rows, res, width):
        """The W pass's arguments to the C entry, its operands made once,
        for each chunk of ``chunk`` rows (a multiple of ``rows``; None: all
        rows in one call): a function of the chunk."""
        m = min(64, res // 2 + 1)
        x = randn((batch, rows, res, width))
        wab = sm.mix_blocks(randn((width, width, 64, 2), 0.1,
                                  torch.float32), m)
        a1, a3 = sm.staged_factors(res, m, "ortho", cuda)
        wst = sm.staged_weight(wab)
        r = batch * rows
        z = torch.empty(m * r * 2 * width, dtype=cd, device=cuda)
        mz = torch.empty(m * r * 2 * width, dtype=cd, device=cuda)
        out = torch.empty_like(x)
        keep.append((x, a1, a3, wst, z, mz, out))

        def calls(chunk):
            chunk = chunk or r
            return [(1, x[r0 // rows:].data_ptr(), a1.data_ptr(),
                     a3.data_ptr(), wst.data_ptr(), z.data_ptr(),
                     mz.data_ptr(), out[r0 // rows:].data_ptr(), res, m,
                     width, width, min(chunk, r - r0), rows,
                     *x.stride()[:3], *out.stride()[:3], 0,
                     torch.cuda.current_stream().cuda_stream)
                    for r0 in range(0, r, chunk)]
        return calls

    keep = []
    # 64 -> 64 over 8 x 256² (the train shape: its four passes), 128 -> 128
    # there, 256 -> 256 on 64 rows
    shapes = {"c64": shape_cases(8, 256, 256, 64, adjoints=True),
              "c128": shape_cases(8, 256, 256, 128),
              "c256": shape_cases(2, 32, 256, 256)}
    direct = {"c64": direct_call(8, 256, 256, 64),
              "c128": direct_call(8, 256, 256, 128),
              "c256": direct_call(2, 32, 256, 256)}
    lib = _build.library
    rounds = {}
    try:
        _build.library = lambda: libs["library"]
        for shape, cases in shapes.items():
            _check_cases(cases, f"library {shape}")
            first = cases["w_pass"][0]().clone()
            if not torch.equal(first, cases["w_pass"][0]()):
                raise AssertionError(f"{shape}: two calls differ")
            print(f"library {shape} w_pass: two calls give the same bits",
                  flush=True)
        # every build's W pass at every shape, and the library's over row
        # chunks at 128 -> 128, in turns: the C entry called on operands
        # made once, 10 passes between two events, so that the device time
        # is measured without the launcher's work on the host
        runs = {}
        for shape in shapes:
            for name in libs:
                runs[name, shape, None] = (libs[name], direct[shape](None))
        for rows in (256, 512):
            runs["library", "c128", rows] = (libs["library"],
                                             direct["c128"](rows))
        for _ in range(5):
            for key, (so, args) in runs.items():
                rounds.setdefault(key, []).append(_calls_ms(so, args))
        for shape, cases in shapes.items():
            for case, (run, plain, _) in cases.items():
                print(f"{shape} {case}: library {_time_ms(run):.4f} ms, "
                      f"plain {_time_ms(plain, reps=5):.4f} ms", flush=True)
        # the launcher's work beside the kernels: the weight's blocks
        # padded and cast, once a call
        for shape, width in (("c64", 64), ("c128", 128), ("c256", 256)):
            wab = sm.mix_blocks(randn((width, width, 64, 2), 0.1,
                                      torch.float32), 64)
            print(f"{shape} staged_weight: "
                  f"{_time_ms(lambda: sm.staged_weight(wab)):.4f} ms",
                  flush=True)
    finally:
        _build.library = lib
    for (name, shape, rows), ts in rounds.items():
        what = f" over chunks of {rows} rows" if rows else ""
        print(f"{name} {shape} w_pass{what}, device: "
              f"{statistics.median(ts):.4f} ms (rounds "
              f"{', '.join(f'{t:.4f}' for t in ts)})", flush=True)
    return 0


def wide_root(root: Path) -> dict:
    """bf16 passes at the widths the models run, through the package in
    ``root``, in a process of its own."""
    code = f"""
import json, statistics, sys
import torch
sys.path.insert(0, {str(root)!r})
torch.backends.cuda.matmul.allow_tf32 = False
from resolution_pde_tpu_torch.ops.kernels import spectral_mix as sm
gen = torch.Generator().manual_seed(0)
cuda, bf = torch.device("cuda"), torch.bfloat16
def randn(shape, scale=1.0, dtype=bf):
    return (torch.randn(shape, generator=gen) * scale).to("cuda", dtype)
def ms(fn, reps=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record(); fn(); b.record(); b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)
rec = dict(root={str(root)!r}, package=sm.__file__)
square = ["w_pass", "h_pass_acc", "w_adjoint"]
for label, shape, wanted in (
        ("c64", (8, 256, 256, 64), square + ["h_adjoint_acc"]),
        ("c64_64sq", (8, 64, 64, 64), square),
        ("c64_128sq", (8, 128, 128, 64), square),
        ("c128", (8, 256, 256, 128), square),
        ("c256", (2, 32, 256, 256), ["w_pass", "w_adjoint"])):
    n, c = shape[2], shape[3]
    m = min(64, n // 2 + 1)
    x = randn(shape)
    acc = randn(shape)
    buf = acc.clone()
    wab = sm.mix_blocks(randn((c, c, 64, 2), 0.1, torch.float32), m)
    wpk = sm.pack_blocks(wab)
    fwd = sm.packed_factors(n, m, "ortho", cuda)
    adj = sm.adjoint_factors(n, m, "ortho", cuda)
    def case_of(adjoint, axis):
        run = sm.spectral_axis_adjoint if adjoint else sm.spectral_axis_pass
        fac, w = (adj, wpk.transpose(1, 2)) if adjoint else (fwd, wpk)
        return (lambda a: run(x, wab, axis, "ortho", bf, acc=a),
                lambda a: sm._plain_axis_pass(x, *fac, w, axis, bf, a))
    calls = dict(w_pass=case_of(False, 2), h_pass_acc=case_of(False, 1),
                 w_adjoint=case_of(True, 2), h_adjoint_acc=case_of(True, 1))
    for case in wanted:
        run, plain = calls[case]
        with_acc = case.endswith("_acc")
        got = run(acc.clone() if with_acc else None).double()
        want = plain(acc.clone() if with_acc else None).double()
        err = float(torch.linalg.vector_norm(got - want)
                    / torch.linalg.vector_norm(want))
        assert err <= 1e-2, (label, case, err)
        rec[f"{{label}}_{{case}}_ms"] = ms(lambda: run(buf if with_acc else None))
        rec[f"{{label}}_{{case}}_rel_l2"] = err
print(json.dumps(rec))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=900, cwd=str(root))
    if res.returncode != 0:
        raise RuntimeError(f"wide passes at {root} failed:\n{res.stdout}\n"
                           f"{res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def e2e(root: Path) -> dict:
    """The predicts and train steps at 8 x 256² through the package in
    ``root``, in a process of its own."""
    code = f"""
import json, statistics, sys, time
import numpy as np, torch
sys.path.insert(0, {str(root)!r})
torch.backends.cuda.matmul.allow_tf32 = False
from resolution_pde_tpu_torch.deploy import ServingEngine
from resolution_pde_tpu_torch.models import FFNO2D
from resolution_pde_tpu_torch.train import Trainer
import resolution_pde_tpu_torch
def model(bf16=False, width=64):
    return FFNO2D(in_channels=1, out_channels=1, width=width, n_layers=4,
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
del trainer, state16, state
eng = ServingEngine(model(bf16=True), device="cuda")
eng.warmup(spatial_shapes=[(256, 256)], batch_sizes=[8])
pred16 = []
for _ in range(10):
    t = time.perf_counter()
    eng.predict(x)
    pred16.append((time.perf_counter() - t) * 1e3)
trainer = Trainer(model(bf16=True, width=128), learning_rate=1e-3,
                  device="cuda")
state128 = trainer.init()
steps128 = []
for i in range(7):
    t = time.perf_counter()
    state128, loss128 = trainer.train_step(state128, xd, yd)
    torch.cuda.synchronize()
    if i >= 2:
        steps128.append((time.perf_counter() - t) * 1e3)
eng = ServingEngine(model(bf16=True, width=128), device="cuda")
eng.warmup(spatial_shapes=[(256, 256)], batch_sizes=[8])
pred128 = []
for _ in range(6):
    t = time.perf_counter()
    eng.predict(x[:5])
    pred128.append((time.perf_counter() - t) * 1e3)
print(json.dumps(dict(root={str(root)!r},
                      package=resolution_pde_tpu_torch.__file__,
                      predict_ms=statistics.median(times),
                      step_ms=statistics.median(steps), loss=float(loss),
                      bf16_step_ms=statistics.median(steps16),
                      bf16_loss=float(loss16),
                      bf16_predict_ms=statistics.median(pred16),
                      w128_bf16_step_ms=statistics.median(steps128),
                      w128_bf16_loss=float(loss128),
                      w128_bf16_predict5_ms=statistics.median(pred128[1:]))))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=1200, cwd=str(root))
    if res.returncode != 0:
        raise RuntimeError(f"e2e at {root} failed:\n{res.stdout}\n"
                           f"{res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def predict_root(root: Path) -> dict:
    """The bf16 FFNO2D predict at 8 x 256² (bench.py's width, random
    weights from seed 0) through the package in ``root``, in a process of
    its own: the median of 30 predicts after 3, and the host time a call
    of the K1f launcher's planner mirror on that chain, as the launcher
    calls it and uncached, where the package has them."""
    code = f"""
import json, statistics, sys, time
import numpy as np, torch
sys.path.insert(0, {str(root)!r})
from resolution_pde_tpu_torch.deploy import ServingEngine
from resolution_pde_tpu_torch.models import FFNO2D
from resolution_pde_tpu_torch.ops.kernels import fused_ff
import resolution_pde_tpu_torch
model = FFNO2D(in_channels=1, out_channels=1, width=64, n_layers=4,
               n_modes=64, factor=4, ff_weight_norm=True, n_ff_layers=3,
               layer_norm=True, dropout=0.0, compute_dtype=torch.bfloat16,
               spectral_impl="pallas2", approx_gelu=True, ff_impl="fused",
               device="cuda", generator=torch.Generator().manual_seed(0))
x = np.random.default_rng(0).standard_normal((8, 1, 256, 256)).astype(
    np.float32)
eng = ServingEngine(model, device="cuda")
eng.warmup(spatial_shapes=[(256, 256)], batch_sizes=[8])
times = []
for i in range(33):
    t = time.perf_counter()
    eng.predict(x)
    if i >= 3:
        times.append((time.perf_counter() - t) * 1e3)
planner = {{}}
chain = ((64, 256, 256, 64), True, True, torch.bfloat16, torch.float32)
for name in ("forward_tile_rows", "_forward_plan"):
    fn = getattr(fused_ff, name, None)
    if fn is not None:
        t = time.perf_counter()
        for _ in range(10000):
            fn(*chain)
        planner[name + "_us"] = (time.perf_counter() - t) * 1e2
print(json.dumps(dict(root={str(root)!r},
                      package=resolution_pde_tpu_torch.__file__,
                      bf16_predict_ms=statistics.median(times),
                      bf16_predict_min_ms=min(times),
                      bf16_predict_max_ms=max(times), **planner)))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=1200, cwd=str(root))
    if res.returncode != 0:
        raise RuntimeError(f"predict at {root} failed:\n{res.stdout}\n"
                           f"{res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/k2_phases")
    ap.add_argument("--wide", action="store_true",
                    help="the bf16 staged route by stage and by design")
    ap.add_argument("--wide-root", action="append", default=[])
    ap.add_argument("--e2e-root", action="append", default=[])
    ap.add_argument("--predict-root", action="append", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k2_phases: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(_smi(), flush=True)
    if args.e2e_root or args.predict_root:
        for root in args.e2e_root or args.predict_root:
            t0 = time.perf_counter()
            rec = (e2e if args.e2e_root else predict_root)(
                Path(root).resolve())
            rec["seconds"] = round(time.perf_counter() - t0, 1)
            print(json.dumps(rec), flush=True)
        return 0
    if args.wide_root:
        for root in args.wide_root:
            print(json.dumps(wide_root(Path(root).resolve())), flush=True)
        return 0
    sys.path.insert(0, str(ROOT))
    if args.wide:
        return wide(Path(args.out) / "staged")
    return phases(Path(args.out) / "k3")


if __name__ == "__main__":
    sys.exit(main())
