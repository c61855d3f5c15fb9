#!/usr/bin/env python3
"""Device-time breakdown of the port's S4 predict on one GPU.

    python3 scripts/torch_s4_serve_profile.py [--requests 10] [--length 512]
                                              [--out build/profile]
                                              [--root DIR ...]

Serves S4Model at the width of configs/model/s4_1d.yaml (mode dplr, the
Cauchy kernel K5) and s4d_1d.yaml (mode diag, the Vandermonde kernel K4),
random weights from seed 0, on the kernels' route (kernel_impl 'pallas')
behind ServingEngine, which replays one CUDA graph per bucket, warmed at
batch 16 x ``--length``; then records
``--requests`` back-to-back predict requests of batch 16 with
torch.profiler (CPU + CUDA activities). Prints the card's name and power
limit and, per model: the median host time of 10 predicts of batch 16 at
L = 128, 256 and 512 (after 3), and from the profile the host time per
predict, the device span per predict, the busy and idle shares of that
span, kernels executed per predict (inside the graph's replay), and
device ms per predict by kind:
  K5       cauchy_kernel
  K4       vandermonde_kernel
  fft      cuFFT kernels (the DPLR kernel's inverse FFT, the FFT conv)
  other    every other kernel (complex algebra, GEMMs, GELU, GLU, copies)
The chrome traces go to ``--out``/s4_<mode>_predict_trace.json and the
summary, as JSON, to ``--out``/s4_predict_profile.json. Needs CUDA.

With ``--root DIR`` (repeatable), the same for the package in each DIR (a
checkout of this repository, whose kernels build into DIR/build), each in
a process of its own, in the order given, one JSON line each: unpack the
parent commit's ``resolution_pde_tpu_torch`` into ``build/parent`` (``git
archive <parent> resolution_pde_tpu_torch | tar -x -C build/parent``) and
pass ``--root build/parent --root . --root . --root build/parent`` to
compare the two trees in one call.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]

# configs/model/s4_1d.yaml / s4d_1d.yaml; configs/training/default.yaml
S4 = dict(d_input=15, d_output=1, d_model=64, n_layers=4, dropout=0.2,
          prenorm=False)
BATCH = 16
LENGTHS = (128, 256, 512)   # configs/dataset/ks_s4.yaml resolutions


def _kind(name: str) -> str:
    if "cauchy_kernel" in name:
        return "K5"
    if "vandermonde_kernel" in name:
        return "K4"
    if "fft" in name.lower():
        return "fft"
    return "other"


def _busy_us(events) -> float:
    """Length of the union of the events' device intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for e in sorted(events, key=lambda e: e.time_range.start):
        s, t = e.time_range.start, e.time_range.end
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    return busy + (cur_e - cur_s)


def profile(mode: str, length: int, requests: int, out: str) -> dict:
    from resolution_pde_tpu_torch.deploy import ServingEngine
    from resolution_pde_tpu_torch.models import S4Model

    model = S4Model(**S4, mode=mode, kernel_impl="pallas", device="cuda",
                    generator=torch.Generator().manual_seed(0))
    eng = ServingEngine(model, device="cuda")
    eng.warmup(spatial_shapes=sorted({*LENGTHS, length}),
               batch_sizes=[BATCH], in_channels=S4["d_input"])
    rng = np.random.default_rng(0)
    medians = {}
    for n in LENGTHS:
        xn = rng.standard_normal((BATCH, S4["d_input"], n)).astype(np.float32)
        times = []
        for i in range(13):
            t0 = time.perf_counter()
            eng.predict(xn)
            if i >= 3:
                times.append((time.perf_counter() - t0) * 1e3)
        medians[str(n)] = statistics.median(times)
    x = rng.standard_normal((BATCH, S4["d_input"], length)).astype(np.float32)
    for _ in range(3):
        eng.predict(x)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(requests):
            eng.predict(x)
        host_ms = (time.perf_counter() - t0) * 1e3 / requests
    prof.export_chrome_trace(os.path.join(out,
                                          f"s4_{mode}_predict_trace.json"))
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        raise RuntimeError("the profiler recorded no device events")
    start = min(e.time_range.start for e in dev)
    end = max(e.time_range.end for e in dev)
    busy = _busy_us(dev)
    kinds = dict.fromkeys(("K5", "K4", "fft", "other"), 0.0)
    for e in dev:
        kinds[_kind(e.name)] += e.time_range.elapsed_us()
    n = requests
    return {
        "mode": mode, "batch": BATCH, "median_ms": medians,
        "length": length, "requests": n,
        "host_ms_per_predict": host_ms,
        "span_ms_per_predict": (end - start) / 1e3 / n,
        "busy_ms_per_predict": busy / 1e3 / n,
        "idle_share": 1.0 - busy / (end - start),
        "device_launches_per_predict": len(dev) / n,
        "ms_per_predict": {k: v / 1e3 / n for k, v in kinds.items()},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--length", type=int, default=512)
    ap.add_argument("--out", default="build/profile")
    ap.add_argument("--root", action="append", default=[],
                    help="time the package in this checkout instead, in a "
                    "process of its own (repeatable)")
    ap.add_argument("--package", default=str(ROOT), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_s4_serve_profile: CUDA is not available",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    if args.root:
        for i, root in enumerate(args.root):
            res = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--package",
                 str(Path(root).resolve()), "--requests", str(args.requests),
                 "--length", str(args.length),
                 "--out", os.path.join(args.out, f"root{i}")],
                capture_output=True, text=True, timeout=900)
            if res.returncode != 0:
                raise RuntimeError(f"{root} failed:\n{res.stdout}\n"
                                   f"{res.stderr}")
            rec = json.loads(res.stdout.strip().splitlines()[-1])
            print(json.dumps({"root": root, **rec}), flush=True)
        return 0
    sys.path.insert(0, args.package)
    os.makedirs(args.out, exist_ok=True)
    import resolution_pde_tpu_torch
    summary = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
               "package": resolution_pde_tpu_torch.__file__,
               "models": [profile(mode, args.length, args.requests, args.out)
                          for mode in ("dplr", "diag")]}
    with open(os.path.join(args.out, "s4_predict_profile.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
