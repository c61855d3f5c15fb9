"""Evaluation of the port: super-resolution sweeps, autoregressive
rollout, per-Fourier-mode error decomposition."""

from resolution_pde_tpu_torch.evaluation.frequency import (
    decompose_error_by_frequency_1d,
    decompose_error_by_frequency_2d,
)
from resolution_pde_tpu_torch.evaluation.rollout import (
    evaluate_rollout_all_resolutions,
    perform_rollout,
    perform_window_rollout,
    rollout_loss,
    window_rollout_loss,
)
from resolution_pde_tpu_torch.evaluation.superres import (
    evaluate_all_resolutions,
    get_lower_resolutions,
)

__all__ = [
    "decompose_error_by_frequency_1d",
    "decompose_error_by_frequency_2d",
    "evaluate_all_resolutions",
    "evaluate_rollout_all_resolutions",
    "get_lower_resolutions",
    "perform_rollout",
    "perform_window_rollout",
    "rollout_loss",
    "window_rollout_loss",
]
