"""The training driver: a closed loop of ``Trainer.train_step`` over a pool
of seeded batches in host memory, one handed over each step as a loader
does.

Set-up builds one Trainer and drives it through the first ``check_steps``
steps on pool batches 0, 1, 2 (rows that all differ) through the same call
and feed as the window; they compile and warm every shape, and the check
reads them: each step's loss, AdamW's first moment after step 1 (the
gradient the optimizer got, times 1 - beta1), the parameters after step 1
and after the last. The window goes on with the same object. After it, the reference
follows the same steps from the same weights and batches.
"""

from __future__ import annotations

import math
import time

import torch

from benchmark import harness, inputs, program
from benchmark.reference import common, precision


def setup(ctx):
    c, dev, ph = ctx.cell, ctx.device, ctx.phases
    tr = c.traffic
    t = time.perf_counter()
    weights = c.ref.make_weights(c.cfg, ctx.seed, dev)
    pool = inputs.pool(ctx.seed, tr, dev, with_target=True)
    harness.sync(dev)
    ph["weights_and_inputs_s"] = time.perf_counter() - t
    t = time.perf_counter()
    model = program.model(c.cfg, "train", weights, dev)
    trainer, state = program.trainer(c.cfg, model, ctx.seed, dev)
    ph["build_s"] = time.perf_counter() - t
    s = dict(cell=c, device=dev, weights=weights, pool=pool, trainer=trainer,
             state=state, losses=[], check_losses=[])
    t = time.perf_counter()
    steps = c.traffic["check_steps"]
    for i in range(steps):
        x, y = pool[i % len(pool)]
        with torch.profiler.record_function("bench.train_step"):
            _, loss = trainer.train_step(state, x, y)
        s["check_losses"].append(float(loss))
        if i == 0:
            s["moments"] = program.first_moments(state)
            s["after_first"] = program.parameters(state)
    s["after"] = program.parameters(state)
    harness.sync(dev)
    ph["check_steps_s"] = time.perf_counter() - t
    s["offset"] = steps
    return s


def unit(s, i: int) -> None:
    pool = s["pool"]
    x, y = pool[(s["offset"] + i) % len(pool)]
    with torch.profiler.record_function("bench.train_step"):
        _, loss = s["trainer"].train_step(s["state"], x, y)
    s["losses"].append(loss)


def summary(s, win) -> dict:
    rows = s["cell"].traffic["rows"]
    losses = torch.stack(s["losses"]).float().cpu() if s["losses"] else None
    bad = int((~torch.isfinite(losses)).sum()) if losses is not None else 0
    return {"attempted": win.units, "failed": bad,
            "end_to_end": {"train_samples_per_s":
                           win.units * rows / win.seconds}}


def flops_per_unit(c) -> float:
    """A step's model operations: forward and backward, 3 forwards."""
    tr = c.traffic
    return 3.0 * c.ref.flops(c.cfg, tr["rows"], tuple(tr["grid"]))


def _block_rows(c) -> int:
    return c.traffic.get("check_block_rows", c.traffic["rows"])


def program_readings(s) -> dict:
    """The program's losses, first gradients, first update and change,
    from set-up; a leaf the optimizer holds no moment of reads as a zero
    gradient."""
    beta1 = s["cell"].cfg["optimizer"]["betas"][0]
    w = s["weights"]
    return {"losses": s["check_losses"],
            "grads": {k: s["moments"][k] / (1.0 - beta1)
                      if k in s["moments"] else w[k] * 0.0 for k in w},
            "update": {k: s["after_first"][k] - w[k] for k in w},
            "change": {k: s["after"][k] - w[k] for k in w}}


def compare(got: dict, ref: dict, log=None) -> dict:
    """The numbers ``correct`` is decided by: the worst relative loss gap
    of the check steps, the worst leaf's gap of first-gradient norms, the
    gap of what the first update buys along the reference's gradient over
    the moved leaves (its direction), and the worst moved leaf's gap of
    change norms after the check steps."""
    loss_gap = max(abs(a - b) / abs(b) if math.isfinite(a) else math.inf
                   for a, b in zip(got["losses"], ref["losses"]))
    grad_gap, grad_at = common.leaf_gap(got["grads"], ref["grads"])
    moved = common.moved_leaves(ref["grads"])
    update_gap = common.descent_gap(got["update"], ref["update"],
                                    ref["grads"], moved)
    change_gap, change_at = common.leaf_gap(got["change"], ref["change"],
                                            moved)
    if log is not None:
        log(f"losses {got['losses']} reference {ref['losses']}; worst "
            f"gradient leaf {grad_at}, worst change leaf {change_at}; "
            f"leaves left out of the change: "
            f"{sorted(k for k, v in moved.items() if not v)}")
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "update_gap": update_gap, "change_gap": change_gap}


def reference(c, weights: dict, pool: list, device, q=None) -> dict:
    """The reference's readings of the check steps (``q``: a control's
    rounding)."""
    steps = c.traffic["check_steps"]
    batches = [(x.to(device), y.to(device))
               for x, y in pool[:steps]]

    def fwd(w, x, qq):
        return c.ref.forward(w, x, c.cfg, qq)

    with common.ieee_f32():
        return common.train_steps(fwd, weights, batches, c.cfg["optimizer"],
                                  _block_rows(c), q or precision.exact)


def check(s, ctx) -> dict:
    got = program_readings(s)
    for k in ("trainer", "state", "losses", "moments", "after_first",
              "after"):
        s.pop(k, None)
    harness.free(ctx.device)
    ref = reference(s["cell"], s["weights"], s["pool"], ctx.device)
    return compare(got, ref, getattr(ctx, "log", None))
