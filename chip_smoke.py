#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (resolution_pde_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises (exit code != 0):
  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: the CUDA kernels, from resolution_pde_tpu_torch/csrc;
  3. K1, the fused FeedForward kernel, against its plain PyTorch version at
     the serving shape (bf16) and at a small ragged f32 shape;
  4. K2, the fused spectral axis pass, against its plain version: bf16 at
     the serving shape and at W = 64 (both axes, the H pass read in place),
     and its f32 mode (K3) at the serving shape;
  5. the slice: FFNO2D at the width of bench.py (random weights from a
     seed) behind ServingEngine on the GPU, warmed, then serving predict
     and forecast requests with the launch counters showing that both
     kernels ran; then one predict in bf16 and one in the f32-exact mode,
     each against the same weights on the CPU through the plain versions.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Needs CUDA: without it, it exits 1 and
prints no result. Plain versions run with TF32 off.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# bench.py:73-110: the flagship FFNO2D serving width
WIDTH, LAYERS, MODES, FACTOR, FF_LAYERS, BATCH, RES = 64, 4, 64, 4, 3, 8, 256
SEED = 0


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median time of ``fn`` on the device, from CUDA events around each run."""
    for _ in range(warm):
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


def randn(shape, gen, scale=1.0, dtype=torch.float32, device="cuda"):
    return (torch.randn(shape, generator=gen) * scale).to(device=device,
                                                          dtype=dtype)


def check_fused_ff(gen) -> dict:
    from resolution_pde_tpu_torch.ops.kernels import fused_ff

    def case(n, dims, *, ln, residual, approx, dtype, tol, label):
        ks = [randn((dims[i], dims[i + 1]), gen, dims[i] ** -0.5)
              for i in range(len(dims) - 1)]
        bs = [randn((d,), gen, 0.1) for d in dims[1:]]
        lnp = (1.0 + randn((dims[-1],), gen, 0.1),
               randn((dims[-1],), gen, 0.1)) if ln else None
        x = randn((n, dims[0]), gen, dtype=dtype)
        res = randn((n, dims[-1]), gen, dtype=dtype) if residual else None
        kw = dict(approx_gelu=approx, compute_dtype=dtype)
        got = fused_ff.fused_feedforward(x, ks, bs, lnp, res, **kw)
        ref = fused_ff.fused_feedforward_reference(x, ks, bs, lnp, res, **kw)
        torch.cuda.synchronize()
        err, mx = rel_l2(got, ref), max_abs(got, ref)
        ms = time_ms(lambda: fused_ff.fused_feedforward(x, ks, bs, lnp, res,
                                                        **kw))
        plain = time_ms(lambda: fused_ff.fused_feedforward_reference(
            x, ks, bs, lnp, res, **kw))
        log("K1", case=label, rows=n, dims="->".join(map(str, dims)),
            rel_l2=f"{err:.3e}", max_abs=f"{mx:.3e}", tol=tol,
            ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}")
        require(bool(torch.isfinite(got.float()).all()) and err <= tol,
                f"K1 {label}: rel_l2 {err} > {tol}")
        return dict(max_abs_err=mx, ms=ms, plain_ms=plain)

    hidden = WIDTH * FACTOR
    dims = [WIDTH] + [hidden] * (FF_LAYERS - 1) + [WIDTH]
    # bf16 output: a rounding flip of a bf16 hidden activation or of the
    # output itself moves an element by up to one bf16 ulp (2^-8 relative)
    bench = case(BATCH * RES * RES, dims, ln=True, residual=True,
                 approx=True, dtype=torch.bfloat16, tol=1e-2,
                 label="serving_bf16")
    # f32: only the order of the f32 sums differs
    case(1000, [24, 40, 40, 24], ln=False, residual=False, approx=False,
         dtype=torch.float32, tol=1e-5, label="ragged_f32")
    return bench


def check_spectral(gen) -> tuple:
    from resolution_pde_tpu_torch.ops.kernels import spectral_mix as sm

    def one_pass(shape, dtype, tol, label):
        b, h, w, c = shape
        m = min(MODES, w // 2 + 1)
        f2, i2 = sm.packed_factors(w, m, "ortho", torch.device("cuda"))
        wpk = sm.pack_mix_weight(randn((c, c, MODES, 2), gen, 0.1), m)
        x = randn(shape, gen, dtype=dtype)
        got = sm.spectral_axis_pass(x, f2, i2, wpk, 2, dtype)
        ref = sm.spectral_pass_reference(
            x.reshape(b * h, w, c), f2, i2, wpk, dtype).reshape(shape)
        torch.cuda.synchronize()
        err, mx = rel_l2(got, ref), max_abs(got, ref)
        ms = time_ms(lambda: sm.spectral_axis_pass(x, f2, i2, wpk, 2, dtype))
        plain = time_ms(lambda: sm.spectral_pass_reference(
            x.reshape(b * h, w, c), f2, i2, wpk, dtype))
        log("K2", case=label, rows=b * h, W=w, C=c, m=m,
            rel_l2=f"{err:.3e}", max_abs=f"{mx:.3e}", tol=tol,
            ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}")
        require(bool(torch.isfinite(got.float()).all()) and err <= tol,
                f"K2 {label}: rel_l2 {err} > {tol}")
        return dict(max_abs_err=mx, ms=ms, plain_ms=plain)

    # bf16: intermediates are rounded to bf16 in both; a rounding flip moves
    # an element by up to one bf16 ulp
    bf16 = one_pass((BATCH, RES, RES, WIDTH), torch.bfloat16, 1e-2,
                    "serving_bf16")
    # f32 mode (K3): IEEE f32 products in both, only the sum order differs
    f32 = one_pass((BATCH, RES, RES, WIDTH), torch.float32, 1e-4,
                   "serving_f32")

    # both axes at W = 64 (m = 33) and H = 48 (m = 25): the H pass reads the
    # channels-last tensor in place and adds into the W pass's output
    x = randn((BATCH, 48, 64, WIDTH), gen, dtype=torch.bfloat16)
    wy = randn((WIDTH, WIDTH, MODES, 2), gen, 0.1)
    wx = randn((WIDTH, WIDTH, MODES, 2), gen, 0.1)
    got = sm.factorized_spectral_conv_2d_pallas2(x, wy, wx, MODES)
    ref = sm.factorized_spectral_conv_2d_pallas2(x.cpu(), wy.cpu(),
                                                 wx.cpu(), MODES)
    err = rel_l2(got.cpu(), ref)
    log("K2", case="both_axes_bf16", shape="8x48x64x64", m="25/33",
        rel_l2=f"{err:.3e}", tol=1e-2)
    require(err <= 1e-2, f"K2 both axes: rel_l2 {err}")
    return bf16, f32


def build_model(device, compute_dtype, spectral_impl, gen=None):
    from resolution_pde_tpu_torch.models import FFNO2D

    return FFNO2D(in_channels=1, out_channels=1, width=WIDTH,
                  n_layers=LAYERS, n_modes=MODES, factor=FACTOR,
                  ff_weight_norm=True, n_ff_layers=FF_LAYERS,
                  layer_norm=True, dropout=0.0, compute_dtype=compute_dtype,
                  spectral_impl=spectral_impl, approx_gelu=True,
                  ff_impl="fused", device=device, generator=gen)


def run_slice(gen) -> dict:
    from resolution_pde_tpu_torch.deploy import ServingEngine
    from resolution_pde_tpu_torch.ops.kernels import fused_ff, spectral_mix
    from resolution_pde_tpu_torch.ops.normalizers import SimpleNormalizer

    norms = dict(x_normalizer=SimpleNormalizer(0.1, 1.3),
                 y_normalizer=SimpleNormalizer(-0.2, 0.9))
    model = build_model("cuda", torch.bfloat16, "pallas2",
                        torch.Generator().manual_seed(SEED))
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    eng = ServingEngine(model, device="cuda", **norms)
    t0 = time.perf_counter()
    eng.warmup(spatial_shapes=[(r, r) for r in (64, 128, RES)],
               batch_sizes=[BATCH], rollout_steps=[4])
    log("slice", warmup_s=f"{time.perf_counter() - t0:.3f}",
        buckets=len(eng.buckets()))
    f32_model = build_model("cuda", None, "pallas")
    f32_model.load_state_dict(state)
    eng32 = ServingEngine(f32_model, device="cuda", **norms)
    eng32.warmup(spatial_shapes=[(128, 128)], batch_sizes=[2])

    rng = np.random.default_rng(SEED)
    reqs = {res: rng.standard_normal((5 if res == RES else BATCH, 1, res,
                                      res)).astype(np.float32)
            for res in (RES, 64, 128)}
    x128 = rng.standard_normal((2, 1, 128, 128)).astype(np.float32)

    def counts():
        return fused_ff.launches, spectral_mix.launches

    # the main path: every launch counted here comes from serving requests
    fused_ff.launches = spectral_mix.launches = 0
    launched = {"bf16": [0, 0], "f32": [0, 0]}
    outs = {}
    for res, x in reqs.items():
        before = counts()
        outs[res] = eng.predict(x)
        d = [a - b for a, b in zip(counts(), before)]
        require(d == [LAYERS, 2 * LAYERS],
                f"predict at {res}^2 launched (K1, K2) {d}")
        launched["bf16"] = [a + b for a, b in zip(launched["bf16"], d)]
    before = counts()
    roll = eng.forecast(reqs[RES], 4)
    d = [a - b for a, b in zip(counts(), before)]
    require(d == [4 * LAYERS, 8 * LAYERS], f"forecast launched {d}")
    launched["bf16"] = [a + b for a, b in zip(launched["bf16"], d)]
    before = counts()
    out32 = eng32.predict(x128)
    d = [a - b for a, b in zip(counts(), before)]
    require(d == [LAYERS, 2 * LAYERS], f"f32 predict launched {d}")
    launched["f32"] = d
    log("slice", launches_k1=counts()[0], launches_k2=counts()[1])

    for res, x in reqs.items():
        require(outs[res].shape == x.shape and np.isfinite(outs[res]).all(),
                f"predict at {res}^2: shape {outs[res].shape} or non-finite")
    require(roll.shape == (5, 4, 1, RES, RES) and np.isfinite(roll).all(),
            f"forecast: shape {roll.shape} or non-finite")

    # the same weights on the CPU through the plain versions, in f32
    cpu_model = build_model("cpu", None, "pallas2")
    cpu_model.load_state_dict(state)
    cpu_eng = ServingEngine(cpu_model, device="cpu", **norms)
    cpu_eng.warmup(spatial_shapes=[(128, 128)], batch_sizes=[2])
    ref = cpu_eng.predict(x128)
    err16 = rel_l2(torch.from_numpy(eng.predict(x128)), torch.from_numpy(ref))
    err32 = rel_l2(torch.from_numpy(out32), torch.from_numpy(ref))
    log("slice", bf16_vs_cpu_f32_rel_l2=f"{err16:.3e}", tol=3e-2,
        f32_vs_cpu_f32_rel_l2=f"{err32:.3e}", tol32=1e-4)
    require(err16 <= 3e-2, f"bf16 slice vs CPU f32: {err16}")
    require(err32 <= 1e-4, f"f32 slice vs CPU f32: {err32}")

    for res, x in reqs.items():
        times = []
        for _ in range(10):
            t = time.perf_counter()
            eng.predict(x)
            times.append((time.perf_counter() - t) * 1e3)
        log("latency", bucket=f"{BATCH}x{res}^2", batch=x.shape[0],
            median_ms=f"{statistics.median(times):.3f}")
    return launched


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    # the plain versions' f32 products must be IEEE f32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log("device", name=name, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda,
        plain_versions_tf32="off")
    print(smi, flush=True)

    from resolution_pde_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    log("build", seconds=f"{time.perf_counter() - t0:.2f}")

    gen = torch.Generator().manual_seed(SEED)
    k1 = check_fused_ff(gen)
    k2, k3 = check_spectral(gen)
    launched = run_slice(gen)

    kernels = [
        dict(name="fused_ff_fwd", route="cuda",
             source="resolution_pde_tpu_torch/csrc/fused_ff.cu",
             replaces="resolution_pde_tpu/ops/pallas/fused_ff.py:84",
             launches=launched["bf16"][0] + launched["f32"][0], **k1),
        dict(name="spectral_pass_bf16", route="cuda",
             source="resolution_pde_tpu_torch/csrc/spectral_mix.cu",
             replaces="resolution_pde_tpu/ops/pallas/spectral_mix2.py:79",
             launches=launched["bf16"][1], **k2),
        dict(name="spectral_pass_f32", route="cuda",
             source="resolution_pde_tpu_torch/csrc/spectral_mix.cu",
             replaces="resolution_pde_tpu/ops/pallas/spectral_mix.py:82",
             launches=launched["f32"][1], **k3),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
