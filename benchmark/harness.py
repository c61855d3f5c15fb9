"""One run of one cell: set-up, the measured window, the traced segment,
the correctness check, and the result line.

Everything a cell is made of is found by name from ``BENCHMARK.json``: its
configuration (the entry's ``file``, which names its reference module
``reference/<reference>.py``), its traffic mix (``traffic/<traffic>.json``,
which names its driver ``drivers/<driver>.py``), its limits
(``limits/<workload>.json``) and each per-layer metric's reader
(``metrics/<metric>.py``). A later cell, mix or metric is a file added
beside these, with no edit here.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from benchmark import tracing

FORBIDDEN = {"jax", "jaxlib", "flax", "resolution_pde_tpu"}
_IMPORTED = time.perf_counter()


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(root: Path, workload: str) -> SimpleNamespace:
    """The cell named ``workload`` with what it is made of, from the
    checkout at ``root``."""
    here = Path(root) / "benchmark"
    bench = load_json(Path(root) / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if workload not in entries:
        raise KeyError(f"unknown workload {workload!r}; one of "
                       f"{sorted(entries)}")
    w = entries[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = load_json(Path(root) / cfg_entry["file"])
    traffic = load_json(here / "traffic" / f"{w['traffic']}.json")
    return SimpleNamespace(
        name=workload, here=here, entry=w, cfg=cfg, traffic=traffic,
        ref=importlib.import_module(f"benchmark.reference.{cfg['reference']}"),
        driver=importlib.import_module(
            f"benchmark.drivers.{traffic['driver']}"),
        limits=load_json(here / "limits" / f"{workload}.json"),
        end_to_end=[m for m in bench["end_to_end"]
                    if workload in m.get("workloads", [workload])],
        per_layer=[m for m in bench["per_layer"]
                   if workload in m.get("workloads", [workload])])


def peaks(here: Path, kind: str) -> dict | None:
    """The published peaks of the card ``kind`` (peaks.json), or None."""
    return load_json(here / "peaks.json").get(kind)


def reader(here: Path, name: str):
    """The ``read`` function of the per-layer metric ``name``."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"),
        here / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def process_age_s() -> float:
    """Seconds since this process started (from /proc), or since the
    harness was imported where /proc is absent."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def window(unit, seconds: float, device, trace: bool) -> SimpleNamespace:
    """Run ``unit(i)`` for i = 0, 1, ... until ``seconds`` have passed, the
    device drained at both ends: (units, seconds). With ``trace``, the
    first half runs untraced (``pre_units`` in ``pre_s``: the traced run's
    host-clock rate) and then torch.profiler records a segment of up to
    4 s (``seg_units`` in ``seg_s``, ``trace``), opened and closed on a
    drained device, so the segment holds all the work of its units; it
    holds one unit at least, the window running on for it if need be."""
    trace_from = seconds / 2.0
    trace_to = trace_from + min(4.0, seconds / 2.0)  # never past seconds
    prof, seg = None, []
    sync(device)
    t0 = time.perf_counter()
    n = 0
    while True:
        now = time.perf_counter() - t0
        if trace and not seg and now >= trace_from:
            sync(device)
            prof = tracing.session()
            prof.start()
            seg = [n, time.perf_counter() - t0]
        elif len(seg) == 2 and now >= trace_to and n > seg[0]:
            sync(device)
            seg += [n, time.perf_counter() - t0]
            prof.stop()
        if now >= seconds and (not trace or len(seg) == 4):
            break
        unit(n)
        n += 1
    sync(device)
    out = SimpleNamespace(units=n, seconds=time.perf_counter() - t0)
    if seg:
        out.trace = tracing.Trace(prof)
        out.pre_units, out.pre_s = seg[0], seg[1]
        out.seg_units, out.seg_s = seg[2] - seg[0], seg[3] - seg[1]
    return out


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run(root, workload: str, seed: int, seconds: float, trace: bool,
        device="cuda", log=None) -> dict:
    """One run of the cell; returns the result line's object (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, with ``trace`` a
    ``breakdown``, and ``checks`` last). ``device`` "cpu" serves the
    tests, at their own sizes: the command line never takes it."""
    log = log or (lambda *a: None)
    c = cell(root, workload)
    dev = torch.device(device)
    is_cuda = dev.type == "cuda"
    phases = {"import_and_init_s": process_age_s()}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    if is_cuda:
        torch.cuda.init()
        torch.empty(1, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
    phases["cuda_init_s"] = time.perf_counter() - t
    if trace and is_cuda:
        t = time.perf_counter()
        tracing.warm()
        phases["profiler_warm_s"] = time.perf_counter() - t
    ctx = SimpleNamespace(cell=c, seed=int(seed), device=dev, phases=phases,
                          log=log)
    state = c.driver.setup(ctx)
    setup_s = process_age_s()
    log(f"setup {setup_s:.3f} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in phases.items()))
    win = window(lambda i: c.driver.unit(state, i), seconds, dev, trace)
    peak = torch.cuda.max_memory_allocated(dev) if is_cuda else 0
    summary = c.driver.summary(state, win)
    kind = torch.cuda.get_device_name(dev) if is_cuda else "cpu"
    reading = None
    if trace:
        reading = SimpleNamespace(
            cfg=c.cfg, traffic=c.traffic, peaks=peaks(c.here, kind),
            trace=win.trace, seg_s=win.seg_s, seg_units=win.seg_units,
            pre_units=win.pre_units, pre_s=win.pre_s, memory_peak_bytes=peak,
            flops_per_unit=c.driver.flops_per_unit(c),
            precision=c.cfg["precision"])
    # the program's state goes before the reference runs
    t = time.perf_counter()
    checks = c.driver.check(state, ctx)
    del state
    free(dev)
    check_s = time.perf_counter() - t
    log(f"window {win.seconds:.3f} s, {win.units} units; "
        f"check {check_s:.3f} s")
    if trace:
        metrics = {}
        for m in c.per_layer:
            v = reader(c.here, m["name"])(reading)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = dict(summary["end_to_end"], setup_s=setup_s)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in c.end_to_end}
    correct = (summary["failed"] == 0 and all(
        math.isfinite(v) and v <= c.limits[k] for k, v in checks.items()))
    out = {"correct": bool(correct), "attempted": summary["attempted"],
           "failed": summary["failed"], "metrics": metrics,
           "device": {"platform": "gpu" if is_cuda else "cpu", "kind": kind,
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if trace:
        out["device"]["busy_s"] = win.trace.busy_s()
        out["device"]["window_s"] = win.seg_s
        out["breakdown"] = {"device_ops": win.trace.top_ops(),
                            "idle_gaps": win.trace.idle_gaps()}
    out["setup"] = phases
    out["check_s"] = check_s
    out["checks"] = {k: {"value": v, "limit": c.limits[k]}
                     for k, v in checks.items()}
    return out
