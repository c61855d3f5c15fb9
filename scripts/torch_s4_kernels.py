#!/usr/bin/env python3
"""The S4 kernels K4 and K5 built alone, with their other designs, timed
on one GPU.

    python3 scripts/torch_s4_kernels.py [--out build/s4_kernels]

Builds ``csrc/vandermonde.cu`` (K4) and ``csrc/cauchy.cu`` (K5) each alone,
as the library does, and as copies with a few lines rewritten (``DESIGNS``:
other designs, and ablations that leave out one part of the work, whose
results are wrong by construction), one ``nvcc`` a build, all started
together; prints each build's registers and spills (``-Xptxas -v``);
checks every design's entries against the plain versions (relative L2
1e-5) at the S4 serving shapes (2 channels x 64 features = 128 rows, K4
N/2 = 32 and K5 N = 64 states, L = 512; random S4D-Lin and HiPPO-LegS
operands from seed 0) and times each entry's C call in a CUDA graph (50
calls a replay, the median of 5 replays a call), beside the device time
of a graph node that adds one to one element (the floor a kernel of a
few microseconds stands on). One JSON line a build; the card's name and
power limit first. Needs CUDA and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from resolution_pde_tpu_torch.ops import ssm  # noqa: E402
from resolution_pde_tpu_torch.ops.kernels import (  # noqa: E402
    _build, cauchy, vandermonde)

CSRC = ROOT / "resolution_pde_tpu_torch" / "csrc"
# each design: the source it rewrites, and (old, new) line rewrites
DESIGNS = {
    "k4": ("vandermonde.cu", {}),
    # a block of 256 positions (8 anchors), two blocks a row at L = 512
    "k4_threads256": ("vandermonde.cu", {
        "constexpr int kVdmThreads = 512;": "constexpr int kVdmThreads = 256;"}),
    # ablations: no powers (dtA itself in the table, C' in the anchors);
    # no sums
    "k4_no_powers": ("vandermonde.cu", {
        "      s_pow[s][jj] = power(s_dta[s], jj);":
            "      s_pow[s][jj] = s_dta[s];",
        "      s_anc[mm][s] = complex_mul(s_cp[s], power(s_dta[s], l0 + kVdmPowers * mm));":
            "      s_anc[mm][s] = s_cp[s];"}),
    "k4_no_sums": ("vandermonde.cu", {
        "      for (int s = 0; s < cn; ++s) {": "      for (int s = 0; s < 0; ++s) {"}),
    "k5": ("cauchy.cu", {}),
    # a row a block, as the plane entry: no sharing between channels
    "k5_rows": ("cauchy.cu", {
        "  if ((rows / h) % 2 == 0)": "  if (false)"}),
    # eight lanes a position, 64 positions a block
    "k5_lanes8": ("cauchy.cu", {
        "constexpr int kCauchyLanes = 4;": "constexpr int kCauchyLanes = 8;"}),
    # ablations: no Woodbury epilogue (the four sums added and stored);
    # no bilinear points (g = i l, c = 1); no sums
    "k5_no_epilogue": ("cauchy.cu", {
        "        complex_mul(c, make_float2(__fsub_rn(k00.x, w.x), __fsub_rn(k00.y, w.y)));":
            "        make_float2(k00.x + k01.x + k10.x + k11.x, "
            "k00.y + k01.y + k10.y + k11.y);"}),
    "k5_no_positions": ("cauchy.cu", {
        "    if (l0 + t < L) ops.position(grp, l0 + t, g, c);":
            "    g = make_float2(0.f, static_cast<float>(l0 + t)), c = make_float2(1.f, 0.f);"}),
    "k5_no_sums": ("cauchy.cu", {
        "    for (int k = lane; k < cn; k += kCauchyLanes) {":
            "    for (int k = lane; k < 0; k += kCauchyLanes) {"}),
}
ABLATIONS = ("_no_",)
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "rpde_vandermonde": [*[_P] * 5, _I, _I, _I, _P],
    "rpde_s4d_kernel": [*[_P] * 4, _I, _I, _I, _I, _P],
    "rpde_cauchy": [*[_P] * 8, _I, _I, _I, _P],
    "rpde_dplr_at_roots": [*[_P] * 6, _I, _I, _I, _I, _P],
}


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def build(out: Path) -> dict:
    """Every design's source written and compiled into a library of its
    own, all at once; returns {design: (library, ptxas lines)}."""
    nvcc = _build._nvcc()
    procs = {}
    for name, (src, edits) in DESIGNS.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        text = (CSRC / src).read_text()
        for old, new in edits.items():
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not one line of {src}")
            text = text.replace(old, new)
        (d / src).write_text(text)
        cmd = (f"{nvcc} {' '.join(_build.NVCC_FLAGS)} -Xptxas -v -I {CSRC} "
               f"-c -o {d / 'k.o'} {d / src} && {nvcc} "
               f"{' '.join(_build.ARCH_FLAGS)} -shared -o {d / 'k.so'} "
               f"{d / 'k.o'}")
        procs[name] = subprocess.Popen(cmd, shell=True, text=True,
                                       stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT)
    built = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name} did not build:\n{log}")
        lib = ctypes.CDLL(str(out / name / "k.so"))
        for fn, args in SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = ctypes.c_int
        regs = [re.sub(r"\s+", " ", line.strip()) for line in log.splitlines()
                if "registers" in line or "spill" in line]
        built[name] = (lib, regs)
    return built


def graph_ms(fn, calls: int = 50, reps: int = 5) -> float:
    """Device time of one call of fn: calls captured in a CUDA graph,
    replayed between CUDA events; the median a call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def operands() -> dict:
    """The S4 serving shapes' operands, on the card: K4 (C, A, log_dt and
    their planes), K5 (Lambda, P, B, C-tilde, log_dt and the four sums'
    planes)."""
    gen = torch.Generator().manual_seed(0)
    ch, h, n_half, n, L = 2, 64, 32, 64, 512

    def log_dt():
        u = torch.rand(h, generator=gen)
        return u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3)

    A = torch.complex(torch.full((h, n_half), -0.5),
                      np.pi * torch.arange(n_half).float().expand(h, -1))
    C = torch.complex(torch.randn((ch, h, n_half), generator=gen),
                      torch.randn((ch, h, n_half), generator=gen))
    k4 = [t.cuda() for t in (C, A, log_dt())]
    lam, p, b, _ = ssm.make_dplr_hippo(n)
    lam, p, b = (torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
        z, (h, n)), np.complex64)) for z in (lam, p, b))
    Ct = torch.complex(torch.randn((ch * h, n), generator=gen),
                       torch.randn((ch * h, n), generator=gen)) * 0.5 ** 0.5
    k5 = [t.cuda() for t in (lam, p, b, Ct, log_dt())]
    v, g, _ = cauchy.dplr_operands(*k5, L)
    lam_rows = k5[0].repeat(ch, 1)
    k5_planes = [t.contiguous() for t in (v.real, v.imag, lam_rows.real,
                                          lam_rows.imag, g.real, g.imag)]
    k4_planes = [t.contiguous() for t in vandermonde.s4d_operands(*k4)]
    return dict(k4=k4, k4_planes=k4_planes, k5=k5, k5_planes=k5_planes, L=L)


def run(name: str, lib, ops: dict) -> dict:
    """Check and time a design's two entries through its library."""
    L = ops["L"]
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    if name.startswith("k4"):
        C, A, log_dt = ops["k4"]
        h, n = A.shape
        rows = C.numel() // n
        out = torch.empty((rows, L), device="cuda")
        planes = ops["k4_planes"]
        pout = torch.empty_like(out)
        fused = lambda: lib.rpde_s4d_kernel(  # noqa: E731
            C.data_ptr(), A.data_ptr(), log_dt.data_ptr(), out.data_ptr(),
            rows, h, n, L, stream())
        plane = lambda: lib.rpde_vandermonde(  # noqa: E731
            *(t.data_ptr() for t in planes), pout.data_ptr(), rows, n, L,
            stream())
        want = vandermonde.s4d_kernel_reference(C, A, log_dt, L).reshape(
            rows, L)
        pwant = vandermonde.vandermonde_reference(*planes, L)
    else:
        lam, p, b, Ct, log_dt = ops["k5"]
        h, n = lam.shape
        rows = Ct.shape[0]
        out = torch.empty((rows, L), dtype=torch.complex64, device="cuda")
        planes = ops["k5_planes"]
        pout = torch.empty((2, 4, rows, L), device="cuda")
        fused = lambda: lib.rpde_dplr_at_roots(  # noqa: E731
            lam.data_ptr(), p.data_ptr(), b.data_ptr(), Ct.data_ptr(),
            log_dt.data_ptr(), out.data_ptr(), rows, h, n, L, stream())
        plane = lambda: lib.rpde_cauchy(  # noqa: E731
            *(t.data_ptr() for t in planes), pout[0].data_ptr(),
            pout[1].data_ptr(), rows, n, L, stream())
        want = cauchy.dplr_at_roots_reference(lam, p, b, Ct, log_dt, L)
        pwant = torch.stack(cauchy.cauchy_reference(*planes))
    for fn, what in ((fused, "fused"), (plane, "plane")):
        err = fn()
        if err != 0:
            raise RuntimeError(f"{name} {what}: cudaError_t {err}")
    torch.cuda.synchronize()
    real = lambda z: torch.view_as_real(z) if z.is_complex() else z  # noqa: E731
    got, ref = real(out).clone(), real(want)
    fused()
    torch.cuda.synchronize()
    rec = dict(design=name, fused_rel_l2=rel_l2(got, ref),
               plane_rel_l2=rel_l2(pout, pwant),
               repeat_bit_equal=bool(torch.equal(got, real(out))),
               fused_ms=graph_ms(fused), plane_ms=graph_ms(plane))
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/s4_kernels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_s4_kernels: CUDA is not available", file=sys.stderr)
        return 1
    print(_smi(), flush=True)
    built = build(Path(args.out).resolve())
    ops = operands()
    one = torch.zeros(1, device="cuda")
    print(json.dumps(dict(graph_node_floor_ms=graph_ms(
        lambda: one.add_(1.0)))), flush=True)
    wrong = []
    for name, (lib, regs) in built.items():
        rec = run(name, lib, ops)
        print(json.dumps(dict(rec, ptxas=regs)), flush=True)
        if not any(a in name for a in ABLATIONS) and not (
                rec["fused_rel_l2"] <= 1e-5 and rec["plane_rel_l2"] <= 1e-5):
            wrong.append(name)
    # the library's own build, through the package's entries, on the same
    # operands
    C, A, log_dt = ops["k4"]
    lib4 = vandermonde.s4d_kernel_pallas(C, A, log_dt, ops["L"])
    lib5 = cauchy.dplr_at_roots(*ops["k5"], ops["L"])
    print(json.dumps(dict(
        design="library",
        k4_fused_rel_l2=rel_l2(lib4, vandermonde.s4d_kernel_reference(
            C, A, log_dt, ops["L"])),
        k5_fused_rel_l2=rel_l2(torch.view_as_real(lib5), torch.view_as_real(
            cauchy.dplr_at_roots_reference(*ops["k5"], ops["L"]))))),
        flush=True)
    if wrong:
        raise AssertionError(f"designs off their plain versions: {wrong}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
