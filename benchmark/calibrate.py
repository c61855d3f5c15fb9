#!/usr/bin/env python3
"""Readings that a cell's limits are set from, in one process on the card:

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,... \
        [--controls 7,8,9] [--faults half_batch,...] [--seconds 2]

For each of ``--seeds`` the program's numbers as a run computes them (a
training cell's check steps; a serving cell's sampled requests over a
window of ``--seconds``); for each of ``--controls`` the control's: the
reference computed one precision below the configuration's
(``reference/precision.py``) in the program's place, against the reference;
for each fault of ``--faults`` (``faults.py``), the program's numbers with
the fault planted, on the control seeds. One JSON line each on standard
output, and the largest program reading and smallest control or fault
reading of each number last.
"""

import argparse
import json
import math
import sys
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]


def program_numbers(c, seed, seconds, dev, log) -> dict:
    from benchmark import harness
    ctx = SimpleNamespace(cell=c, seed=int(seed), device=dev, phases={},
                          log=log)
    state = c.driver.setup(ctx)
    if c.traffic["driver"] == "serve":
        harness.window(lambda i: c.driver.unit(state, i), seconds,
                       ctx.device, False)
    return c.driver.check(state, ctx)


def control_numbers(c, seed, dev, log) -> dict:
    from benchmark import inputs
    from benchmark.reference import precision
    q = precision.CONTROL[c.cfg["precision"]]
    weights = c.ref.make_weights(c.cfg, seed, dev)
    if c.traffic["driver"] == "train":
        pool = inputs.pool(seed, c.traffic, dev, with_target=True)
        ref = c.driver.reference(c, weights, pool, dev)
        ctl = c.driver.reference(c, weights, pool, dev, q=q)
        return c.driver.compare(ctl, ref, log)
    pool = [x.numpy() for x in inputs.pool(seed, c.traffic, dev,
                                            with_target=False)]
    needed = list(range(len(pool)))
    ctl = c.driver.reference_outputs(c, weights, pool, needed, dev, q=q)
    return c.driver.judge(c, weights, pool,
                          [(j, ctl[j].numpy()) for j in needed], dev)


def unit_numbers(c, seed, dev, log) -> dict:
    """The numbers of the reference rounded to the configuration's own
    precision (``precision.UNIT``) in the program's place: what the
    precision alone costs on this seed."""
    from benchmark import inputs
    from benchmark.reference import precision
    q = precision.UNIT[c.cfg["precision"]]
    weights = c.ref.make_weights(c.cfg, seed, dev)
    pool = inputs.pool(seed, c.traffic, dev, with_target=True)
    ref = c.driver.reference(c, weights, pool, dev)
    got = c.driver.reference(c, weights, pool, dev, q=q)
    return c.driver.compare(got, ref, log)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--controls", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--units", action="store_true",
                   help="a training cell: also the reference rounded to the "
                   "configuration's precision, on each program seed")
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import faults, harness
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = harness.cell(ROOT, args.workload)
    dev = torch.device("cuda")

    def log(m):
        print(m, file=sys.stderr, flush=True)

    def seeds(s):
        return [int(v) for v in s.split(",") if v]

    lo, hi = {}, {}
    for seed in seeds(args.seeds):
        got = program_numbers(c, seed, args.seconds, dev, log)
        harness.free(dev)
        print(json.dumps({"seed": seed, "kind": "program", **got}), flush=True)
        for k, v in got.items():
            lo[k] = max(lo.get(k, 0.0), v)
        if args.units and c.traffic["driver"] == "train":
            got = unit_numbers(c, seed, dev, log)
            harness.free(dev)
            print(json.dumps({"seed": seed, "kind": "unit", **got}),
                  flush=True)
    for seed in seeds(args.controls):
        got = control_numbers(c, seed, dev, log)
        harness.free(dev)
        print(json.dumps({"seed": seed, "kind": "control", **got}), flush=True)
        for k, v in got.items():
            hi.setdefault("control", {})[k] = min(
                hi.get("control", {}).get(k, math.inf), v)
        for name in [f for f in args.faults.split(",") if f]:
            with faults.FAULTS[name]():
                got = program_numbers(c, seed, args.seconds, dev, log)
            harness.free(dev)
            print(json.dumps({"seed": seed, "kind": name, **got}), flush=True)
            for k, v in got.items():
                hi.setdefault(name, {})[k] = min(
                    hi.get(name, {}).get(k, math.inf), v)
    print(json.dumps({"lower": lo, "upper": hi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
