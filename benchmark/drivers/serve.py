"""The serving driver: one client in a closed loop sends
``ServingEngine.predict`` requests of ``rows`` fields from a seeded pool in
host memory, each timed from the call (numpy in) to its numpy output.

Set-up warms the traffic's one bucket (a CUDA graph on the card) and sends
``warm_requests`` requests. In the window a sample of ``sample`` requests,
drawn from the seed over all the window's requests (reservoir sampling),
keeps its outputs; after the window the reference computes each sampled
request's input again and the worst row's relative L2 gap is compared
(``out_gap``). Under a bf16 configuration each row's gap is read in units
of the gap that rounding the reference's operands to bf16 gives on the
same row (``out_gap_bf16``): with random weights the output's norm, and so
a relative gap, swings eightfold from seed to seed where that unit follows
it.
"""

from __future__ import annotations

import random
import statistics
import time

import numpy as np
import torch

from benchmark import harness, inputs, program
from benchmark.reference import common, precision


def setup(ctx):
    c, dev, ph = ctx.cell, ctx.device, ctx.phases
    tr = c.traffic
    t = time.perf_counter()
    weights = c.ref.make_weights(c.cfg, ctx.seed, dev)
    pool = [x.numpy() for x in inputs.pool(ctx.seed, tr, dev,
                                           with_target=False)]
    harness.sync(dev)
    ph["weights_and_inputs_s"] = time.perf_counter() - t
    t = time.perf_counter()
    model = program.model(c.cfg, "serve", weights, dev)
    eng = program.engine(model, tr, dev)
    ph["build_and_capture_s"] = time.perf_counter() - t
    t = time.perf_counter()
    for i in range(tr["warm_requests"]):
        eng.predict(pool[i % len(pool)])
    ph["warm_requests_s"] = time.perf_counter() - t
    return dict(cell=c, weights=weights, pool=pool, engine=eng,
                latencies=[], sample=[], seen=0,
                rng=random.Random(ctx.seed * 7919 + 17), bad=0)


def unit(s, i: int) -> None:
    pool = s["pool"]
    j = i % len(pool)
    x = pool[j]
    t = time.perf_counter()
    with torch.profiler.record_function("bench.predict"):
        out = s["engine"].predict(x)
    s["latencies"].append(time.perf_counter() - t)
    if out.shape[0] != x.shape[0] or out.dtype != np.float32:
        s["bad"] += 1
    # reservoir sampling: every request of the window equally likely kept
    k, seen = s["cell"].traffic["sample"], s["seen"]
    if seen < k:
        s["sample"].append((j, out))
    else:
        r = s["rng"].randrange(seen + 1)
        if r < k:
            s["sample"][r] = (j, out)
    s["seen"] = seen + 1


def summary(s, win) -> dict:
    rows = s["cell"].traffic["rows"]
    lat = s["latencies"]
    p95 = (statistics.quantiles(lat, n=100, method="inclusive")[94]
           if len(lat) > 1 else (lat[0] if lat else float("nan")))
    return {"attempted": win.units, "failed": s["bad"],
            "end_to_end": {"predict_rows_per_s": win.units * rows
                           / win.seconds,
                           "predict_p95_ms": 1e3 * p95}}


def flops_per_unit(c) -> float:
    tr = c.traffic
    return c.ref.flops(c.cfg, tr["rows"], tuple(tr["grid"]))


def reference_outputs(c, weights: dict, pool: list, needed, device,
                      q=None) -> dict:
    """{pool index: the reference's output} for the pool entries
    ``needed``, each in blocks of ``check_block_rows`` rows."""
    block = c.traffic.get("check_block_rows", c.traffic["rows"])
    out = {}
    with common.ieee_f32(), torch.no_grad():
        for j in sorted(set(needed)):
            x = torch.as_tensor(pool[j], device=device)
            out[j] = torch.cat([
                c.ref.forward(weights, x[r:r + block], c.cfg,
                              q or precision.exact).cpu()
                for r in range(0, x.shape[0], block)])
    return out


def compare(sample: list, ref: dict, unit: dict | None = None) -> dict:
    """The worst row's relative L2 gap over the sampled requests, or with
    ``unit`` (the reference at the precision's rounding) the worst row's
    gap over that row's unit gap."""
    if unit is None:
        return {"out_gap": max((common.row_gap(torch.as_tensor(out), ref[j])
                                for j, out in sample), default=0.0)}
    return {"out_gap_bf16": max(
        (common.row_gap_in(torch.as_tensor(out), ref[j], unit[j])
         for j, out in sample), default=0.0)}


def judge(c, weights, pool, sample, device, q=None) -> dict:
    """``compare`` of ``sample`` [(pool index, output)] against the
    reference (and its unit, where the precision has one)."""
    needed = [j for j, _ in sample]
    ref = reference_outputs(c, weights, pool, needed, device)
    u = precision.UNIT.get(c.cfg["precision"])
    unit = (reference_outputs(c, weights, pool, needed, device, q=u)
            if u is not None else None)
    return compare(sample, ref, unit)


def check(s, ctx) -> dict:
    s.pop("engine", None)
    harness.free(ctx.device)
    return judge(s["cell"], s["weights"], s["pool"], s["sample"], ctx.device)
