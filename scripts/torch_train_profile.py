#!/usr/bin/env python3
"""Device-time breakdown of the port's FFNO2D train step on one GPU.

    python3 scripts/torch_train_profile.py [--steps 5] [--out build/profile]
                                           [--f32] [--predict]

Trains FFNO2D at the width of bench.py:73-110 (bf16, spectral_impl
'pallas2', ff_impl 'fused', random weights from seed 0; with ``--f32`` the
f32-exact mode, compute_dtype None and spectral_impl 'pallas') on bench.py's
synthetic task (8 x 256², y = x rolled by 7 along W) through the port's
Trainer, warms 3 steps, then records ``--steps`` steps with torch.profiler
(CPU + CUDA activities, no host sync inside the window). Prints the card's
name and power limit, the window's device span per step, the busy and idle
shares, and device ms per step by kernel family:
  K1f      fused_ff_fwd_mma_kernel, fused_ff_fwd_f32_kernel and
           fused_ff_fwd_kernel (the fused FeedForward forward: bf16, f32,
           and f32 chains too wide for fused_ff_fwd_f32_kernel)
  K1b      fused_ff_bwd_kernel + reduce_slabs_kernel (its backward)
  K2       the staged route's staged_forward_kernel, staged_mix_kernel
           and staged_inverse_kernel (bf16, three launches a pass) and
           spectral_pass_kernel (f32, one launch a pass), launched in the
           forward pass
  K2adj    the same kernels launched in the backward pass (the adjoint):
           of a step's spectral launches, in order, the first half are the
           forward's and the second half the adjoint's
  other    every other kernel (projections, weight gradients of the
           spectral passes, casts, AdamW, ...) and copies
The chrome trace goes to ``--out``/train_step_trace.json and the summary,
as JSON, to ``--out``/train_step_profile.json (``_f32`` before ``.json``
with ``--f32``). With ``--predict`` it profiles ``--steps`` serving
requests instead, ``ServingEngine.predict`` of a batch of 8 at 256² after
3 warm ones (each ends in its device-to-host copy; every spectral launch
is a K2), into predict_trace.json and predict_profile.json. Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _family(name: str) -> str:
    if ("fused_ff_fwd_mma_kernel" in name or "fused_ff_fwd_f32_kernel" in name
            or "fused_ff_fwd_kernel" in name):
        return "K1f"
    if ("fused_ff_bwd_kernel" in name or "fused_ff_bwd_f32_kernel" in name
            or "reduce_slabs_kernel" in name):
        return "K1b"
    if "spectral_pass" in name or "staged_" in name:
        return "K2"
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default="build/profile")
    ap.add_argument("--f32", action="store_true",
                    help="profile the f32-exact step instead of the bf16 one")
    ap.add_argument("--predict", action="store_true",
                    help="profile serving predicts instead of train steps")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_profile: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    from resolution_pde_tpu_torch.deploy import ServingEngine
    from resolution_pde_tpu_torch.models import FFNO2D
    from resolution_pde_tpu_torch.train import Trainer

    model = FFNO2D(in_channels=1, out_channels=1, width=64, n_layers=4,
                   n_modes=64, factor=4, ff_weight_norm=True, n_ff_layers=3,
                   layer_norm=True, dropout=0.0,
                   compute_dtype=None if args.f32 else torch.bfloat16,
                   spectral_impl="pallas" if args.f32 else "pallas2",
                   approx_gelu=True, ff_impl="fused", device="cuda",
                   generator=torch.Generator().manual_seed(0))
    x = np.random.default_rng(0).standard_normal((8, 1, 256, 256))
    x = x.astype(np.float32)
    if args.predict:
        eng = ServingEngine(model, device="cuda")
        eng.warmup(spatial_shapes=[(256, 256)], batch_sizes=[8])

        def call():
            return float(np.abs(eng.predict(x)).mean())
    else:
        trainer = Trainer(model, learning_rate=1e-3, device="cuda")
        state = trainer.init()
        xd = torch.from_numpy(x).cuda()
        yd = torch.roll(xd, 7, dims=-1)

        def call():
            nonlocal state
            state, loss = trainer.train_step(state, xd, yd)
            return loss
    for _ in range(3):
        loss = call()
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.steps):
            loss = call()
        torch.cuda.synchronize()
    os.makedirs(args.out, exist_ok=True)
    tag = "_f32" if args.f32 else ""
    what = "predict" if args.predict else "train_step"
    prof.export_chrome_trace(os.path.join(args.out, f"{what}_trace{tag}.json"))

    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        print("torch_train_profile: the profiler recorded no device "
              "events", file=sys.stderr)
        return 1
    dev.sort(key=lambda e: e.time_range.start)
    start = dev[0].time_range.start
    end = max(e.time_range.end for e in dev)
    busy, cur_s, cur_e = 0.0, None, None
    for e in dev:  # union of the device intervals
        s, t = e.time_range.start, e.time_range.end
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    busy += cur_e - cur_s
    fam = {"K1f": 0.0, "K1b": 0.0, "K2": 0.0, "K2adj": 0.0, "other": 0.0}
    launches = dict.fromkeys(fam, 0)
    # 2 forward + 2 adjoint passes a layer, each 3 launches in bf16 (the
    # staged route's stages) and 1 in f32
    per_step = 4 * len(model.fourier_layers) * (1 if args.f32 else 3)
    n_spectral = 0
    for e in dev:
        f = _family(e.name)
        if f == "K2" and not args.predict:
            if (n_spectral % per_step) >= per_step // 2:
                f = "K2adj"
            n_spectral += 1
        fam[f] += e.time_range.elapsed_us()
        launches[f] += 1
    n = args.steps
    span_ms = (end - start) / 1e3 / n
    summary = {
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "mode": "f32" if args.f32 else "bf16", "what": what,
        "steps": n, "span_ms_per_step": span_ms,
        "busy_ms_per_step": busy / 1e3 / n,
        "idle_share": 1.0 - busy / (end - start),
        "ms_per_step": {k: v / 1e3 / n for k, v in fam.items()},
        "share_of_span": {k: v / (end - start) for k, v in fam.items()},
        "launches_per_step": {k: v / n for k, v in launches.items()},
        "loss": float(loss),
    }
    with open(os.path.join(args.out, f"{what}_profile{tag}.json"), "w") as f:
        json.dump(summary, f, indent=1)
    top = prof.key_averages().table(sort_by="device_time_total", row_limit=25)
    print(top)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
