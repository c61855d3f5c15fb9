"""Autoregressive rollout evaluation.

Counterpart of resolution_pde_tpu/evaluation/rollout.py (reference
utils/autoregressive_step.py:11-310): the initial condition is
trajectory[:, 0] encoded with the x normalizer; each step feeds the
normalized state through the model, keeps the NORMALIZED prediction, and
feeds back ``x_normalizer.encode(y_normalizer.decode(pred))``; the loss
is the mean over steps of the per-step batch-mean relative L2 between the
decoded rollout and the raw trajectory[:, 1:steps+1]. A Python loop over
the steps takes the place of ``lax.scan``. States are (B, C, S) in 1D
and (B, C, H, W) in 2D.

The S4 family's window rollout (``perform_window_rollout``,
``window_rollout_loss``; ``window_size`` > 1): the state is the last W
frames (B, W, X), seeded with the first W normalized frames; each step
predicts the next frame, round-trips it through the normalizers and
shifts the window; the decoded rollout is scored against frames
[W, W + steps).

Every function here runs the model in eval mode (``eval_mode``: the JAX
package's ``deterministic=True``, so no dropout, and BatchNorm reads its
running statistics and leaves them as they are) and gives the caller's
mode back. The losses' forwards run on the model's device under
``torch.inference_mode()``; the per-step losses add up on the device and
are fetched once per resolution. Not ported: ``mesh=``.
"""

from __future__ import annotations

import contextlib
import time
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch

from resolution_pde_tpu_torch.evaluation.superres import (
    _resize_spatial,
    get_lower_resolutions,
    model_device,
    on_device,
)
from resolution_pde_tpu_torch.models.registry import unwrap_output
from resolution_pde_tpu_torch.ops.normalizers import adapt_normalizer


@contextlib.contextmanager
def eval_mode(model):
    """The model in eval mode within the block, its mode before restored
    after it."""
    was_training = model.training
    model.eval()
    try:
        yield model
    finally:
        model.train(was_training)


def _per_step_rel_l2(preds, gt, eps: float = 1e-8):
    """(steps,) per-step batch-mean relative L2 of (B, steps, *spatial)
    predictions and targets, each (sample, step) flattened, in f32."""
    b, s = preds.shape[0], preds.shape[1]
    p = preds.reshape(b, s, -1).float()
    g = gt.reshape(b, s, -1).float()
    diff = torch.linalg.vector_norm(p - g, dim=-1)
    tgt = torch.linalg.vector_norm(g, dim=-1)
    return (diff / (tgt + eps)).mean(dim=0)


def perform_rollout(model, initial_condition, rollout_steps: int,
                    x_normalizer=None, y_normalizer=None,
                    resize_to: Optional[int] = None):
    """Roll the model forward ``rollout_steps`` steps.

    initial_condition: NORMALIZED state (B, C, *spatial). Returns the
    NORMALIZED predictions (B, rollout_steps, C, *spatial). resize_to: a
    fixed-size model rolled out at another resolution resizes each state
    to its size and the prediction back, so the state stays at the test
    resolution."""

    def apply_model(state):
        test_size = state.shape[-1]
        if resize_to is not None and test_size != resize_to:
            ndim = state.ndim - 2
            pred = unwrap_output(model(_resize_spatial(state, resize_to,
                                                       ndim)))
            return _resize_spatial(pred, test_size, ndim)
        return unwrap_output(model(state))

    state, preds = initial_condition, []
    with eval_mode(model):
        for _ in range(rollout_steps):
            pred = apply_model(state)
            if y_normalizer is not None and x_normalizer is not None:
                state = x_normalizer.encode(y_normalizer.decode(pred))
            else:
                state = pred
            preds.append(pred)
    return torch.stack(preds, dim=1)


def rollout_loss(model, trajectories, rollout_steps: int,
                 x_normalizer=None, y_normalizer=None,
                 batch_size: int = 16,
                 per_step_losses: Optional[list] = None,
                 resize_to: Optional[int] = None,
                 spatial_ndim: int = 1) -> float:
    """Mean over steps of the per-step batch-mean relative L2
    (autoregressive_step.py:190-197).

    trajectories: raw (N, T, *spatial) ground truth (a channel axis is
    added), or (N, T, C, *spatial). per_step_losses: an optional list,
    filled in place with the (steps,) loss curve."""
    n, t = trajectories.shape[0], trajectories.shape[1]
    has_channel = trajectories.ndim == 3 + spatial_ndim
    steps = min(rollout_steps, t - 1)
    if steps <= 0:
        raise ValueError(
            f"cannot roll out: trajectories have {t} frame(s) and "
            f"rollout_steps={rollout_steps}")
    if n == 0:
        # NaN, the failed-resolution sentinel: 0.0 would read as perfect
        warnings.warn("rollout_loss: empty trajectory set, returning NaN",
                      stacklevel=2)
        if per_step_losses is not None:
            per_step_losses[:] = [float("nan")] * steps
        return float("nan")

    device = model_device(model)
    sp_shape = trajectories.shape[-spatial_ndim:]
    x_normalizer = adapt_normalizer(on_device(x_normalizer, device), sp_shape)
    y_normalizer = adapt_normalizer(on_device(y_normalizer, device), sp_shape)

    total, batches = None, 0
    with torch.inference_mode(), eval_mode(model):
        for i in range(0, n, batch_size):
            traj = torch.as_tensor(np.asarray(trajectories[i:i + batch_size]),
                                   device=device)
            ic = traj[:, 0] if has_channel else traj[:, 0][:, None]
            if x_normalizer is not None:
                ic = x_normalizer.encode(ic)
            preds = perform_rollout(model, ic, steps, x_normalizer,
                                    y_normalizer, resize_to=resize_to)
            if y_normalizer is not None:
                preds = y_normalizer.decode(preds)
            gt = traj[:, 1:steps + 1]
            losses = _per_step_rel_l2(preds if has_channel else preds[:, :, 0],
                                      gt)
            total = losses if total is None else total + losses
            batches += 1
    per_step = total.cpu().numpy() / max(batches, 1)  # one host fetch
    if per_step_losses is not None:
        per_step_losses[:] = per_step.tolist()
    return float(per_step.mean())


def perform_window_rollout(model, initial_window, rollout_steps: int,
                           x_normalizer=None, y_normalizer=None):
    """Roll a sliding-window (S4-style) model forward: each step predicts
    the next frame from the window (B, W, X) and the window shifts by one,
    with the normalizer round-trip of ``perform_rollout`` between steps.

    initial_window: NORMALIZED (B, W, X). Returns the NORMALIZED
    predictions (B, rollout_steps, 1, X)."""
    window, preds = initial_window, []
    with eval_mode(model):
        for _ in range(rollout_steps):
            pred = unwrap_output(model(window))[:, -1:]  # (B, 1, X)
            nxt = pred
            if y_normalizer is not None and x_normalizer is not None:
                nxt = x_normalizer.encode(y_normalizer.decode(pred))
            window = torch.cat([window[:, 1:], nxt], dim=1)
            preds.append(pred)
    return torch.stack(preds, dim=1)


def window_rollout_loss(model, trajectories, rollout_steps: int,
                        window_size: int, x_normalizer=None,
                        y_normalizer=None, batch_size: int = 16,
                        per_step_losses: Optional[list] = None) -> float:
    """Mean over steps of the per-step batch-mean relative L2 for window
    models: seed with the first ``window_size`` frames of the raw
    trajectories (N, T, X), score the decoded rollout against frames
    [W, W + steps)."""
    n, t = trajectories.shape[0], trajectories.shape[1]
    steps = min(rollout_steps, t - window_size)
    if steps <= 0:
        raise ValueError(
            f"trajectories of {t} frames cannot seed a window of "
            f"{window_size} and roll out")
    if n == 0:
        warnings.warn(
            "window_rollout_loss: empty trajectory set, returning NaN",
            stacklevel=2)
        if per_step_losses is not None:
            per_step_losses[:] = [float("nan")] * steps
        return float("nan")

    device = model_device(model)
    sp_shape = trajectories.shape[2:]
    x_normalizer = adapt_normalizer(on_device(x_normalizer, device), sp_shape)
    y_normalizer = adapt_normalizer(on_device(y_normalizer, device), sp_shape)

    total, batches = None, 0
    with torch.inference_mode(), eval_mode(model):
        for i in range(0, n, batch_size):
            traj = torch.as_tensor(np.asarray(trajectories[i:i + batch_size]),
                                   device=device)
            win = traj[:, :window_size]
            if x_normalizer is not None:
                win = x_normalizer.encode(win)
            preds = perform_window_rollout(model, win, steps, x_normalizer,
                                           y_normalizer)
            if y_normalizer is not None:
                preds = y_normalizer.decode(preds)
            gt = traj[:, window_size:window_size + steps]
            losses = _per_step_rel_l2(preds[:, :, 0], gt)
            total = losses if total is None else total + losses
            batches += 1
    per_step = total.cpu().numpy() / max(batches, 1)  # one host fetch
    if per_step_losses is not None:
        per_step_losses[:] = per_step.tolist()
    return float(per_step.mean())


def evaluate_rollout_all_resolutions(
    model,
    rollout_builder: Callable,
    current_res: int,
    test_resolutions=None,
    max_test_resolution: Optional[int] = None,
    rollout_steps: int = 16,
    x_normalizer=None,
    y_normalizer=None,
    batch_size: int = 16,
    strict: bool = False,
    window_size: int = 1,
    per_step_out: Optional[Dict[int, list]] = None,
    resize_to_train: bool = False,
    spatial_ndim: int = 1,
    seconds_out: Optional[Dict[int, float]] = None,
) -> Dict[int, float]:
    """Rollout loss at every resolution; ``rollout_builder(res)`` returns
    the raw trajectories (N, T, *spatial) at that resolution (or an object
    with ``.u``). per_step_out and seconds_out: optional dicts, filled
    {res: per-step losses} and {res: wall seconds}. resize_to_train: a
    fixed-size (CNO) model round-trips each step through ``current_res``.
    window_size > 1 selects the sliding-window rollout (S4-style models),
    on raw trajectories (N, T, X)."""
    if test_resolutions is None:
        test_resolutions = get_lower_resolutions(
            max_test_resolution or current_res)
    results: Dict[int, float] = {}
    with eval_mode(model):
        for res in test_resolutions:
            t0 = time.perf_counter()
            try:
                traj = rollout_builder(res)
                u = traj.u if hasattr(traj, "u") else np.asarray(traj)
                per_step: list = []
                if window_size > 1:
                    results[res] = window_rollout_loss(
                        model, u, rollout_steps, window_size, x_normalizer,
                        y_normalizer, batch_size, per_step_losses=per_step)
                else:
                    results[res] = rollout_loss(
                        model, u, rollout_steps, x_normalizer, y_normalizer,
                        batch_size, per_step_losses=per_step,
                        resize_to=(current_res if resize_to_train
                                   and res != current_res else None),
                        spatial_ndim=spatial_ndim)
                if per_step_out is not None:
                    per_step_out[res] = per_step
            except Exception as e:  # a failed resolution is recorded as NaN
                if strict:
                    raise
                print(f"rollout at resolution {res} failed: {e!r}")
                results[res] = float("nan")
            if seconds_out is not None:
                seconds_out[res] = time.perf_counter() - t0
    return results
