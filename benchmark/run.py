#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result as the last line
of standard output.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Needs a CUDA card: without one, or with fewer
cards than the cell asks for, it exits with code 2 and prints no result.
With ``--trace 0`` the result holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics. The numbers that decide ``correct``
close standard error, each beside its limit, and close the result line
under ``checks``.
"""

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "bench_cache"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # every cache the program or torch may write stays in the checkout, at
    # a fixed path, so that only a checkout's first run builds
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    chips = harness.cell(ROOT, args.workload).entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {chips} CUDA card(s); found "
              f"{found}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = harness.run(ROOT, args.workload, args.seed, args.seconds,
                         bool(args.trace), device="cuda",
                         log=lambda m: print(m, file=sys.stderr, flush=True))
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: modules of JAX or of the JAX package were loaded: "
              f"{', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
