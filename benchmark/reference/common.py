"""What the plain references share: the loss, AdamW written out, the first
training steps in blocks of rows, and the gaps that decide ``correct``.

Nothing here imports the program under test; the references read the
program's outputs only to judge them.
"""

from __future__ import annotations

import contextlib
import math

import torch


@contextlib.contextmanager
def ieee_f32():
    """float32 products in IEEE float32 (TF32 off) inside the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def relative_l2_sum(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Sum over the rows of ||pred - target|| / (||target|| + 1e-8), each row
    flattened (the relative L2 loss of Tran et al.'s FFNO code, summed)."""
    dt = torch.promote_types(pred.dtype, torch.float32)
    p = pred.flatten(1).to(dt)
    t = target.flatten(1).to(dt)
    return ((p - t).norm(dim=1) / (t.norm(dim=1) + 1e-8)).sum()


def adamw_step(params: dict, grads: dict, state: dict, step: int, lr: float,
               weight_decay: dict, betas=(0.9, 0.999), eps=1e-8) -> None:
    """One AdamW step (Loshchilov and Hutter) on ``params`` in place:
    decoupled decay p -= lr wd p, then p -= lr m_hat / (sqrt(v_hat) + eps)
    with bias-corrected moments. ``weight_decay``: {name: wd}; ``state``:
    {name: (m, v)}, filled at the first step."""
    b1, b2 = betas
    for name, p in params.items():
        g = grads[name]
        m, v = state.setdefault(name, (torch.zeros_like(p),
                                       torch.zeros_like(p)))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        p.mul_(1 - lr * weight_decay[name])
        denom = (v.sqrt() / math.sqrt(1 - b2 ** step)).add_(eps)
        p.addcdiv_(m, denom, value=-lr / (1 - b1 ** step))


def train_steps(forward, weights: dict, batches: list, optimizer: dict,
                block_rows: int, q) -> dict:
    """The first ``len(batches)`` AdamW steps of ``forward(weights, x, q)``
    on the mean relative L2 loss, from ``weights`` (not changed). The
    gradient of a batch is summed over blocks of ``block_rows`` rows, so the
    activations of one block are held at a time. Returns {"losses": [float],
    "grads": {name: the first step's gradient}, "update": {name: the
    parameters after the first step minus ``weights``}, "change": {name:
    the parameters after the last step minus ``weights``}}. ``optimizer``:
    learning_rate, weight_decay, betas, eps and no_decay (names whose last
    part takes no decay)."""
    params = {k: v.detach().clone() for k, v in weights.items()}
    no_decay = set(optimizer.get("no_decay", ()))
    wd = {k: 0.0 if k.rsplit(".", 1)[-1] in no_decay
          else optimizer["weight_decay"] for k in params}
    state, losses, first, update = {}, [], None, None
    for step, (x, y) in enumerate(batches, start=1):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        grads = {k: torch.zeros_like(v) for k, v in params.items()}
        total = 0.0
        for r0 in range(0, x.shape[0], block_rows):
            xb, yb = x[r0:r0 + block_rows], y[r0:r0 + block_rows]
            loss = relative_l2_sum(forward(leaves, xb, q), yb) / x.shape[0]
            got = torch.autograd.grad(loss, list(leaves.values()),
                                      allow_unused=True)
            for k, g in zip(leaves, got):
                if g is not None:
                    grads[k] += g
            total += float(loss.detach())
            del loss, got
        losses.append(total)
        if first is None:
            first = {k: g.clone() for k, g in grads.items()}
        with torch.no_grad():
            adamw_step(params, grads, state, step, optimizer["learning_rate"],
                       wd, tuple(optimizer["betas"]), optimizer["eps"])
        if update is None:
            update = {k: params[k] - weights[k] for k in params}
    change = {k: params[k] - weights[k] for k in params}
    return {"losses": losses, "grads": first, "update": update,
            "change": change}


def leaf_gap(got: dict, ref: dict, rule: dict | None = None) -> tuple:
    """The worst leaf's gap of norms, | ||got|| - ||ref|| | over the larger
    of ||ref|| and the median leaf's ||ref||, over the leaves of ``ref`` (or
    those that ``rule`` keeps). Returns (gap, the leaf's name)."""
    names = [k for k in ref if rule is None or rule[k]]
    norms = {k: float(ref[k].float().norm()) for k in names}
    med = sorted(norms.values())[len(norms) // 2]
    worst, at = 0.0, None
    for k in names:
        g = abs(float(got[k].float().norm()) - norms[k]) / max(norms[k], med,
                                                                1e-30)
        if not math.isfinite(g):
            return math.inf, k
        if g >= worst:
            worst, at = g, k
    return worst, at


def descent_gap(got: dict, ref: dict, grads: dict, rule: dict) -> float:
    """The gap of what an update buys to first order, the inner product
    <g, u> of the reference's gradient ``grads`` with the update, summed
    over the leaves that ``rule`` keeps: | <g, got> - <g, ref> | over
    | <g, ref> |. A norm cannot see an update's direction (AdamW's first
    step is about -lr sign(g), whose norm hardly depends on g); this reads
    2 for an update of the wrong sign, 1 for none, and about twice the
    share of the gradient's L1 mass whose sign came out wrong. Summed over
    the model rather than taken by the worst leaf, it leaves out the one
    leaf whose rounding swings by seed; one leaf's update flipped still
    moves it by twice that leaf's share."""
    names = [k for k in ref if rule[k]]

    def dot(upd):
        return sum(float((grads[k].double() * upd[k].double()).sum())
                   for k in names)

    d = dot(ref)
    gap = abs(dot(got) - d) / max(abs(d), 1e-300)
    return gap if math.isfinite(gap) else math.inf


def moved_leaves(ref_grads: dict, share: float = 1e-3) -> dict:
    """{name: whether the leaf's reference gradient is above ``share`` of the
    median leaf's}: a leaf below is nought to rounding (a bias that a
    normalisation after it cancels), and Adam moves it by round-off alone."""
    norms = {k: float(g.float().norm()) for k, g in ref_grads.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return {k: n > share * med for k, n in norms.items()}


def row_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst row's relative L2 gap ||got - ref|| / ||ref||."""
    g = got.flatten(1).float()
    r = ref.flatten(1).float()
    gap = (g - r).norm(dim=1) / r.norm(dim=1).clamp(min=1e-30)
    worst = float(gap.max())
    return worst if math.isfinite(worst) else math.inf


def row_gap_in(got: torch.Tensor, ref: torch.Tensor,
               unit: torch.Tensor) -> float:
    """The worst row's ||got - ref|| over that row's ||unit - ref||."""
    g, r, u = (t.flatten(1).float() for t in (got, ref, unit))
    gap = (g - r).norm(dim=1) / (u - r).norm(dim=1).clamp(min=1e-30)
    worst = float(gap.max())
    return worst if math.isfinite(worst) else math.inf
