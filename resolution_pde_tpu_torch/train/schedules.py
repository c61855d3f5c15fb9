"""Learning-rate schedules with torch.optim.lr_scheduler semantics, stepped
per epoch.

Counterpart of resolution_pde_tpu/train/schedules.py (that module cannot be
imported here: its package imports JAX). The schedules return plain Python
floats per epoch, which the trainer writes into the optimizer's param
groups:
  - CosineAnnealingLR(T_max=100, eta_min=1e-5);
  - StepLR(step_size=30, gamma=0.5);
  - ReduceLROnPlateau on the validation loss.
"""

from __future__ import annotations

import math


def cosine_annealing_lr(base_lr: float, t_max: int, eta_min: float = 0.0):
    """lr(e) = eta_min + (base_lr - eta_min) * (1 + cos(pi * e / T_max)) / 2."""

    def schedule(epoch: int) -> float:
        return eta_min + (base_lr - eta_min) * (
            1 + math.cos(math.pi * epoch / t_max)
        ) / 2

    return schedule


def step_lr(base_lr: float, step_size: int, gamma: float = 0.5):
    """lr(e) = base_lr * gamma ** (e // step_size)."""

    def schedule(epoch: int) -> float:
        return base_lr * gamma ** (epoch // step_size)

    return schedule


def constant_lr(base_lr: float):
    def schedule(epoch: int) -> float:
        return base_lr

    return schedule


class ReduceLROnPlateau:
    """Host-side plateau scheduler (torch defaults: factor=0.1, patience=10,
    mode='min'). Call .step(val_loss) each epoch; read .lr."""

    def __init__(self, base_lr: float, factor: float = 0.1, patience: int = 10,
                 min_lr: float = 0.0, threshold: float = 1e-4):
        self.lr = base_lr
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.threshold = threshold
        self.best = math.inf
        self.num_bad = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr

    def state_dict(self) -> dict:
        """The plateau counters, for a checkpoint's ``extra`` payload: they
        live outside the train state, and a mid-run resume needs them."""
        return {"lr": self.lr, "best": self.best, "num_bad": self.num_bad}

    def load_state_dict(self, sd: dict) -> None:
        self.lr = float(sd["lr"])
        self.best = float(sd["best"])
        self.num_bad = int(sd["num_bad"])


def get_schedule(name: str, base_lr: float, epochs: int, **kw):
    """Schedule registry keyed by reference scheduler names."""
    if name in ("cosine", "CosineAnnealingLR"):
        return cosine_annealing_lr(
            base_lr, kw.get("t_max", 100), kw.get("eta_min", 1e-5))
    if name in ("step", "StepLR"):
        return step_lr(base_lr, kw.get("step_size", 30), kw.get("gamma", 0.5))
    if name in ("constant", "none"):
        return constant_lr(base_lr)
    raise ValueError(f"unknown schedule {name!r}")
