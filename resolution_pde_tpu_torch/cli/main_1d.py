"""Training driver (reference main_1d.py:33-310), for 1D and, through
main_2d, 2D data.

    python -m resolution_pde_tpu_torch.cli.main_1d model=... dataset=... \\
        training.epochs=100

Counterpart of resolution_pde_tpu/cli/main_1d.py: the same prints, tables
under ``runs/``, checkpoint under ``checkpoints/`` (both in the working
directory) and returned dict, plus the seconds of each resolution's sweep
and rollout (``eval_seconds``, ``rollout_seconds``). ``main`` runs on the
card unless the caller passes ``device="cpu"``; a CUDA device without
CUDA raises. Not ported: ``save_figures`` (utils/plotting, ROADMAP.md
section 1, item 8) and ``training.cno_resize_training`` (CNO, item 7),
which raise NotImplementedError.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import torch

from resolution_pde_tpu_torch.cli import common
from resolution_pde_tpu_torch.configs import instantiate_dataset, parse_cli
from resolution_pde_tpu_torch.evaluation import (
    evaluate_all_resolutions,
    evaluate_rollout_all_resolutions,
)
from resolution_pde_tpu_torch.utils.metrics import MetricsLogger


def _platform(device: torch.device) -> str:
    if device.type == "cuda":
        return f"cuda({torch.cuda.get_device_name(device)})"
    return device.type


def main(argv=None, spatial_ndim: int = 1, device="cuda"):
    device = common.require_device(device, "main")
    cfg = parse_cli(argv if argv is not None else sys.argv[1:])
    if cfg.training.get("cno_resize_training"):
        raise NotImplementedError(
            "training.cno_resize_training (CNO) is not ported: ROADMAP.md "
            "section 1, item 7")
    save_figures = bool(cfg.get("save_figures",
                                cfg.training.get("save_figures", False)))
    if save_figures:
        raise NotImplementedError(
            "save_figures (utils/plotting) is not ported: ROADMAP.md "
            "section 1, item 8")
    norm_type = cfg.dataset.dataset_params.get("normalization_type", "simple")

    data = instantiate_dataset(cfg.dataset.dataset_params)
    bundle = common.unpack_data(data, norm_type)

    # The JAX 2D driver multiplies the batch by its mesh's data extent
    # (reference main_2d.py:88-94, a constant per-device batch); the port
    # runs on one card, so the factor is 1.
    batch_size = cfg.training.get("batch_size", 16)
    train_loader, val_loader, test_loader = common.build_loaders(
        bundle, batch_size, cfg.dataset.get("train_mres", False),
        seed=cfg.training.get("seed", 0))

    model = common.build_model(cfg)
    trainer = common.build_trainer(cfg, model, bundle["y_normalizer"],
                                   device=device)
    state = trainer.init()
    state = common.maybe_warm_start(cfg, trainer, state)

    n_params = sum(p.numel() for p in state.model.parameters())
    print(f"Total model parameters: {n_params / 1e6:.2f}M")

    logger = MetricsLogger(cfg.project_name, config=cfg,
                           use_wandb=cfg.get("log_to_wandb", False))

    schedule = common.build_schedule(cfg)
    # training.resume_from: continue a killed run exactly
    state, prior_hist, epochs_done, schedule = common.maybe_resume(
        cfg, state, schedule, train_loader=train_loader)
    t_fit = time.perf_counter()
    state, history = trainer.fit(
        state,
        train_loader,
        val_loader,
        epochs=max(cfg.training.get("epochs", 1) - epochs_done, 0),
        schedule=schedule,
        log_fn=logger.log,
        epoch_callback=common.periodic_checkpointer(cfg, schedule,
                                                    prior_hist=prior_hist),
    )
    if prior_hist:
        # the restored epochs in front: the saved history covers the run
        for k in ("train_loss", "val_loss", "lr"):
            if k in prior_hist:
                getattr(history, k)[:0] = [float(v) for v in prior_hist[k]]
    train_seconds = time.perf_counter() - t_fit

    test_loss = trainer.evaluate(state, test_loader)
    print(f"Test L2 loss: {test_loss:.6f}")
    logger.log({"test_loss": test_loss})

    ckpt_path = common.save_run_checkpoint(cfg, state, history, schedule)
    print(f"Checkpoint saved: {ckpt_path}")

    # --- super-resolution sweep (naive_utils / resize_utils) ---
    results, eval_seconds = {}, {}
    if cfg.dataset.get("max_test_resolution"):
        sweep = evaluate_all_resolutions(
            state.model, common.make_superres_builder(cfg),
            current_res=common.eval_train_res(cfg),
            max_test_resolution=cfg.dataset.get("max_test_resolution"),
            x_normalizer=bundle["x_normalizer"],
            y_normalizer=bundle["y_normalizer"],
            batch_size=batch_size,
            spatial_ndim=spatial_ndim,
            resize_to_train=common.resize_trained(cfg),
        )
        results, eval_seconds = sweep["results"], sweep["seconds"]
        logger.log_table(
            "super_resolution", ["resolution", "rel_l2"],
            [(r, v) for r, v in sorted(results.items())])
        for r, v in sorted(results.items()):
            print(f"Resolution {r:4d}: rel-L2 {v:.6f}")

    # --- autoregressive rollout (autoregressive_step), wherever the
    # dataset carries rollout trajectories: the 2D factories do ---
    rollout_results, rollout_seconds = {}, {}
    if (bundle["rollout"] is not None
            and cfg.dataset.get("rollout_steps", 0) > 0):
        rollout_per_step = {}
        rollout_results = evaluate_rollout_all_resolutions(
            state.model,
            common.make_rollout_builder(cfg, bundle["rollout"]),
            current_res=common.eval_train_res(cfg),
            max_test_resolution=cfg.dataset.get("max_test_resolution"),
            rollout_steps=cfg.dataset.get("rollout_steps", 16),
            x_normalizer=bundle["x_normalizer"],
            y_normalizer=bundle["y_normalizer"],
            batch_size=batch_size,
            window_size=common.rollout_window_size(cfg),
            per_step_out=rollout_per_step,
            resize_to_train=common.rollout_resize_to_train(cfg),
            spatial_ndim=spatial_ndim,
            seconds_out=rollout_seconds,
        )
        logger.log_table(
            "rollout", ["resolution", "rollout_rel_l2"],
            [(r, v) for r, v in sorted(rollout_results.items())])
        for r, curve in sorted(rollout_per_step.items()):
            logger.log_table(
                f"rollout_steps_res{r}", ["step", "rel_l2"],
                [(s + 1, v) for s, v in enumerate(curve)])
        for r, v in sorted(rollout_results.items()):
            print(f"Rollout @ {r:4d}: rel-L2 {v:.6f}")

    logger.finish()
    dp = cfg.dataset.dataset_params
    return {
        "test_loss": test_loss,
        "super_resolution": results,
        "rollout": rollout_results,
        "checkpoint": ckpt_path,
        "history": history,
        "n_params": int(n_params),
        "train_seconds": train_seconds,
        "eval_seconds": eval_seconds,
        "rollout_seconds": rollout_seconds,
        "provenance": {
            "platform": _platform(device),
            "epochs": int(cfg.training.get("epochs", 0)),
            "dataset": str(dp.get("filename")
                           or dp.get("filename_pattern")
                           or dp.get("saved_folder") or ""),
            "git_sha": _leg_git_sha(),
        },
    }


def _leg_git_sha() -> str:
    """The checkout's short commit, or "" outside a git checkout."""
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        r = subprocess.run(["git", "-C", repo, "rev-parse", "--short",
                            "HEAD"], capture_output=True, timeout=10)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return r.stdout.decode().strip() if r.returncode == 0 else ""


if __name__ == "__main__":
    main()
