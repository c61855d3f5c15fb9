"""Training driver (reference main_1d.py:33-310), for 1D and, through
main_2d, 2D data.

    python -m resolution_pde_tpu_torch.cli.main_1d model=... dataset=... \\
        training.epochs=100

Counterpart of resolution_pde_tpu/cli/main_1d.py: the same prints, tables
under ``runs/``, checkpoint under ``checkpoints/`` (both in the working
directory) and returned dict, plus the seconds of each resolution's sweep
and rollout (``eval_seconds``, ``rollout_seconds``). ``main`` runs on the
card unless the caller passes ``device="cpu"``; a CUDA device without
CUDA raises. ``training.cno_resize_training`` resizes every train, val
and test batch on the device to ``dataset.cno_train_size`` (else
``original_res``), CNO's fixed size (``train.cno_resize``). ``save_figures=true`` writes the
JAX package's figures and CSV under ``figures/<project_name>_<time>``
(utils/plotting; matplotlib, imported when the first figure is drawn).

Under ``torchrun`` (``WORLD_SIZE`` set) ``main`` starts the process group
(NCCL on the card, each rank on its ``LOCAL_RANK`` card; gloo on the CPU)
and trains data-parallel over every rank (``parallel.make_mesh()``); in
2D the batch is multiplied by the data extent, as JAX's main_1d does
with its mesh (reference main_2d.py:88-94), and the sweep and rollout shard
their batches too. Only rank 0 prints, and writes checkpoints, figures,
tables and logs.
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
from resolution_pde_tpu_torch.parallel.mesh import (data_axis_size,
                                                    init_from_env, is_lead,
                                                    make_mesh)
from resolution_pde_tpu_torch.utils.metrics import MetricsLogger


def _platform(device: torch.device) -> str:
    if device.type == "cuda":
        return f"cuda({torch.cuda.get_device_name(device)})"
    return device.type


class _Quiet:
    """The metrics logger of a rank other than 0: it writes nothing."""

    def log(self, *args, **kwargs):
        pass

    def log_table(self, *args, **kwargs):
        pass

    def finish(self):
        pass


def main(argv=None, spatial_ndim: int = 1, device="cuda"):
    device = common.require_device(device, "main")
    device, started = init_from_env(device)
    try:
        return _run(argv, spatial_ndim, device)
    finally:
        if started:
            torch.distributed.destroy_process_group()


def _run(argv, spatial_ndim, device):
    cfg = parse_cli(argv if argv is not None else sys.argv[1:])
    mesh = (make_mesh() if torch.distributed.is_available()
            and torch.distributed.is_initialized() else None)
    lead = is_lead()
    say = print if lead else (lambda *a, **k: None)
    save_figures = bool(cfg.get("save_figures",
                                cfg.training.get("save_figures", False)))
    norm_type = cfg.dataset.dataset_params.get("normalization_type", "simple")

    data = instantiate_dataset(cfg.dataset.dataset_params)
    bundle = common.unpack_data(data, norm_type)

    batch_size = cfg.training.get("batch_size", 16)
    if spatial_ndim == 2:
        # reference main_2d.py:88-94: the global batch grows with the
        # data-parallel extent, the batch a rank holds stays constant
        batch_size *= data_axis_size(mesh)
    train_loader, val_loader, test_loader = common.build_loaders(
        bundle, batch_size, cfg.dataset.get("train_mres", False),
        seed=cfg.training.get("seed", 0))
    if cfg.training.get("cno_resize_training"):
        # baseline config 4: every batch antialias-resized to the model's
        # fixed training resolution, on the device
        from resolution_pde_tpu_torch.train.cno_resize import ResizingLoader

        size = (cfg.dataset.get("cno_train_size")
                or cfg.dataset.get("original_res"))
        train_loader, val_loader, test_loader = (
            ResizingLoader(loader, size, spatial_ndim, device)
            for loader in (train_loader, val_loader, test_loader))

    model = common.build_model(cfg)
    trainer = common.build_trainer(cfg, model, bundle["y_normalizer"],
                                   device=device, mesh=mesh)
    state = trainer.init()
    state = common.maybe_warm_start(cfg, trainer, state)

    n_params = sum(p.numel() for p in state.model.parameters())
    say(f"Total model parameters: {n_params / 1e6:.2f}M")

    logger = (MetricsLogger(cfg.project_name, config=cfg,
                            use_wandb=cfg.get("log_to_wandb", False))
              if lead else _Quiet())

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
    say(f"Test L2 loss: {test_loss:.6f}")
    logger.log({"test_loss": test_loss})

    ckpt_path = common.save_run_checkpoint(cfg, state, history, schedule)
    say(f"Checkpoint saved: {ckpt_path}")

    # --- super-resolution sweep (naive_utils / resize_utils) ---
    fig_dir = None
    if save_figures:
        # reference writes figures/<job_id> (main_1d.py:208-210)
        fig_dir = os.path.join("figures",
                               f"{cfg.project_name}_{int(time.time())}")
    results, eval_seconds = {}, {}
    sweep = None
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
            analyze_frequencies=save_figures,
            n_plot_examples=5 if save_figures else 0,
            mesh=mesh,
        )
        results, eval_seconds = sweep["results"], sweep["seconds"]
        logger.log_table(
            "super_resolution", ["resolution", "rel_l2"],
            [(r, v) for r, v in sorted(results.items())])
        for r, v in sorted(results.items()):
            say(f"Resolution {r:4d}: rel-L2 {v:.6f}")

    if save_figures and sweep is not None and lead:
        _write_figures(cfg, sweep, fig_dir, spatial_ndim)

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
            mesh=mesh,
        )
        logger.log_table(
            "rollout", ["resolution", "rollout_rel_l2"],
            [(r, v) for r, v in sorted(rollout_results.items())])
        for r, curve in sorted(rollout_per_step.items()):
            logger.log_table(
                f"rollout_steps_res{r}", ["step", "rel_l2"],
                [(s + 1, v) for s, v in enumerate(curve)])
        for r, v in sorted(rollout_results.items()):
            say(f"Rollout @ {r:4d}: rel-L2 {v:.6f}")

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


def _write_figures(cfg, sweep, fig_dir: str, spatial_ndim: int) -> None:
    """JAX's main_1d figure set (its cli/main_1d.py figure block) from
    the sweep's results, examples and frequency decompositions."""
    from resolution_pde_tpu_torch.utils import plotting as P

    results = sweep["results"]
    pde = cfg.dataset.get("pde", "pde")
    P.plot_super_resolution(results, save_path=os.path.join(
        fig_dir, f"{pde}_super_resolution.png"))
    P.save_results_csv(results, os.path.join(
        fig_dir, f"{pde}_super_resolution.csv"),
        columns=("resolution", "rel_l2"))
    P.plot_examples_multiple(sweep["plot_data"], pde=pde, save_dir=fig_dir,
                             spatial_ndim=spatial_ndim)
    if spatial_ndim == 2 and sweep["plot_data"]:
        P.plot_ns_channels(sweep["plot_data"], save_dir=fig_dir)
    for res, (err, mag, freqs) in sweep["frequency_data"].items():
        P.plot_frequency_decomposition(
            err, mag, freqs,
            save_path=os.path.join(fig_dir, f"{pde}_frequency_res{res}.png"))
    if sweep["frequency_data"]:
        # the reference's combined multi-resolution overlay
        # (utils/frequency_analysis_plot.py:9-129)
        P.plot_frequency_analysis(sweep["frequency_data"], pde=pde,
                                  current_res=common.eval_train_res(cfg),
                                  save_dir=fig_dir)
    if (spatial_ndim == 2
            and cfg.dataset.get("evaluation_type") == "use_resize"
            and sweep["plot_data"]):
        base = max(sweep["plot_data"])
        x0 = sweep["plot_data"][base]["inputs"][:1, :1]
        for res in sorted(results):
            if res != base:
                P.analyze_resize_frequencies(x0, base, res, save_dir=fig_dir)
    print(f"Figures written to {fig_dir}")


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
