"""Rollout evaluation driver (reference autoregressive_eval.py:31-223):
load a checkpoint, re-run the teacher-forcing sweep and the rollout at
every resolution.

    python -m resolution_pde_tpu_torch.cli.autoregressive_eval \\
        model=ffno_2d dataset=ns_naive \\
        dataset.saved_checkpoint_path=checkpoints/ffno2d/ns_local

Counterpart of resolution_pde_tpu/cli/autoregressive_eval.py: the same
tables under ``runs/<project>_rollout/`` and the same returned dict. The
checkpoint is the port's format (``train/checkpoint.py``), as ``main_1d``
writes it. The spatial rank comes from the test targets' layout, as
``frequency_evaluation`` infers it, where the JAX driver leaves the sweep
and the rollout at their 1D default, which a 2D checkpoint's rollout does
not run on. ``main`` runs on the card unless the caller passes
``device="cpu"``; a CUDA device without CUDA raises.
"""

from __future__ import annotations

import sys

from resolution_pde_tpu_torch.cli import common
from resolution_pde_tpu_torch.configs import instantiate_dataset, parse_cli
from resolution_pde_tpu_torch.evaluation import (
    evaluate_all_resolutions,
    evaluate_rollout_all_resolutions,
)
from resolution_pde_tpu_torch.utils.metrics import MetricsLogger


def main(argv=None, spatial_ndim: int | None = None, device="cuda"):
    device = common.require_device(device, "main")
    cfg = parse_cli(argv if argv is not None else sys.argv[1:])
    norm_type = cfg.dataset.dataset_params.get("normalization_type", "simple")

    data = instantiate_dataset(cfg.dataset.dataset_params)
    bundle = common.unpack_data(data, norm_type)
    if spatial_ndim is None:
        spatial_ndim = common.target_spatial_ndim(cfg, bundle["test"])

    model = common.build_model(cfg)
    trainer = common.build_trainer(cfg, model, bundle["y_normalizer"],
                                   device=device)
    state = common.maybe_warm_start(cfg, trainer, trainer.init())

    batch_size = cfg.training.get("batch_size", 16)
    logger = MetricsLogger(cfg.project_name + "_rollout", config=cfg,
                           use_wandb=cfg.get("log_to_wandb", False))

    sweep = evaluate_all_resolutions(
        state.model, common.make_superres_builder(cfg),
        current_res=common.eval_train_res(cfg),
        max_test_resolution=cfg.dataset.get("max_test_resolution"),
        x_normalizer=bundle["x_normalizer"],
        y_normalizer=bundle["y_normalizer"],
        batch_size=batch_size,
        spatial_ndim=spatial_ndim,
    )
    per_step = {}
    rollout = evaluate_rollout_all_resolutions(
        state.model,
        common.make_rollout_builder(cfg, bundle["rollout"]),
        current_res=common.eval_train_res(cfg),
        max_test_resolution=cfg.dataset.get("max_test_resolution"),
        rollout_steps=cfg.dataset.get("rollout_steps", 16),
        x_normalizer=bundle["x_normalizer"],
        y_normalizer=bundle["y_normalizer"],
        batch_size=batch_size,
        window_size=common.rollout_window_size(cfg),
        per_step_out=per_step,
        # fixed-size (CNO) models roll out off the train resolution
        # through the per-step resize round trip
        resize_to_train=common.rollout_resize_to_train(cfg),
        spatial_ndim=spatial_ndim,
    )
    logger.log_table("teacher_forcing", ["resolution", "rel_l2"],
                     sorted(sweep["results"].items()))
    logger.log_table("rollout", ["resolution", "rollout_rel_l2"],
                     sorted(rollout.items()))
    for r, curve in sorted(per_step.items()):
        # the reference's per-step rollout CSV (autoregressive_step.py:415)
        logger.log_table(f"rollout_steps_res{r}", ["step", "rel_l2"],
                         [(s + 1, v) for s, v in enumerate(curve)])
    logger.finish()
    for r in sorted(rollout):
        print(f"res {r:4d}: teacher-forcing {sweep['results'][r]:.6f} "
              f"rollout {rollout[r]:.6f}")
    return {"teacher_forcing": sweep["results"], "rollout": rollout,
            "rollout_per_step": per_step}


if __name__ == "__main__":
    main()
