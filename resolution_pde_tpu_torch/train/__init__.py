"""Training harness: train and eval steps, torch-semantics LR schedules,
``torch.save`` checkpoints (blocking or asynchronous)."""

from resolution_pde_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                       save_checkpoint,
                                                       wait_for_checkpoints)
from resolution_pde_tpu_torch.train.schedules import (ReduceLROnPlateau,
                                                      constant_lr,
                                                      cosine_annealing_lr,
                                                      get_schedule, step_lr)
from resolution_pde_tpu_torch.train.trainer import History, Trainer, TrainState

__all__ = [
    "History",
    "ReduceLROnPlateau",
    "Trainer",
    "TrainState",
    "constant_lr",
    "cosine_annealing_lr",
    "get_schedule",
    "restore_checkpoint",
    "save_checkpoint",
    "step_lr",
    "wait_for_checkpoints",
]
