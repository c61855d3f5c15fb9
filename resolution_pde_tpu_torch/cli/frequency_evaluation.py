"""Frequency-analysis driver (reference frequency_evaluation.py:31-165):
load one or more checkpoints (e.g. an alpha sweep,
utils/multiresolution_analysis.py:13-73) and decompose each one's error
on the test split by Fourier mode.

    python -m resolution_pde_tpu_torch.cli.frequency_evaluation \\
        model=ffno_2d dataset=ns_naive \\
        "dataset.model_checkpoints={0.0: ckpt_a, 1.0: ckpt_b}"

Counterpart of resolution_pde_tpu/cli/frequency_evaluation.py: the same
tables under ``runs/<project>_freq/`` and the same returned dict
({checkpoint key: error_per_mode, magnitude_per_mode, frequencies}). The
checkpoints are the port's format (``train/checkpoint.py``). The spectra's
sums add up on the device and are fetched once per checkpoint. ``main``
runs on the card unless the caller passes ``device="cpu"``; a CUDA device
without CUDA raises.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from resolution_pde_tpu_torch.cli import common
from resolution_pde_tpu_torch.configs import instantiate_dataset, parse_cli
from resolution_pde_tpu_torch.evaluation.frequency import (
    finalize_frequency_1d,
    finalize_frequency_2d,
    spectrum_sums_1d,
    spectrum_sums_2d,
)
from resolution_pde_tpu_torch.models.registry import unwrap_output
from resolution_pde_tpu_torch.train.checkpoint import restore_checkpoint
from resolution_pde_tpu_torch.utils.metrics import MetricsLogger


def main(argv=None, spatial_ndim: int | None = None, device="cuda"):
    device = common.require_device(device, "main")
    cfg = parse_cli(argv if argv is not None else sys.argv[1:])
    norm_type = cfg.dataset.dataset_params.get("normalization_type", "simple")

    data = instantiate_dataset(cfg.dataset.dataset_params)
    bundle = common.unpack_data(data, norm_type)
    test = bundle["test"]
    if spatial_ndim is None:
        spatial_ndim = common.target_spatial_ndim(cfg, test)
    yn = bundle["y_normalizer"]
    yn = yn.to(device) if yn is not None else None

    model = common.build_model(cfg)
    trainer = common.build_trainer(cfg, model, bundle["y_normalizer"],
                                   device=device)
    template = trainer.init()

    checkpoints = cfg.dataset.get("model_checkpoints")
    if not checkpoints:
        ckpt = cfg.dataset.get("saved_checkpoint_path")
        if not ckpt:
            raise ValueError(
                "provide dataset.model_checkpoints (dict) or "
                "dataset.saved_checkpoint_path")
        checkpoints = {"default": ckpt}

    logger = MetricsLogger(cfg.project_name + "_freq", config=cfg,
                           use_wandb=cfg.get("log_to_wandb", False))
    batch_size = cfg.training.get("batch_size", 16)
    sums_fn = spectrum_sums_1d if spatial_ndim == 1 else spectrum_sums_2d
    results = {}
    for key, path in checkpoints.items():
        state, _ = restore_checkpoint(path, template)
        state.model.eval()
        err_acc = mag_acc = None
        spatial_shape = None
        with torch.inference_mode():
            for i in range(0, len(test), batch_size):
                bx = torch.as_tensor(test.x[i:i + batch_size], device=device)
                by = torch.as_tensor(test.y[i:i + batch_size], device=device)
                pred = unwrap_output(state.model(bx)).float()
                if yn is not None:
                    pred, by = yn.decode(pred), yn.decode(by)
                es, ms = sums_fn(pred, by)
                # the last spatial_ndim axes: window (S4) targets carry no
                # channel axis
                spatial_shape = by.shape[by.ndim - spatial_ndim:]
                if err_acc is None:
                    err_acc, mag_acc = es, ms
                else:
                    err_acc, mag_acc = err_acc + es, mag_acc + ms
        if spatial_ndim == 1:
            err, mag, freqs = finalize_frequency_1d(err_acc, mag_acc,
                                                    spatial_shape[-1])
        else:
            err, mag, freqs = finalize_frequency_2d(err_acc, mag_acc,
                                                    *spatial_shape)
        results[key] = {"error_per_mode": err, "magnitude_per_mode": mag,
                        "frequencies": freqs}
        logger.log_table(
            f"frequency_{key}", ["frequency", "error", "magnitude"],
            list(zip(freqs.tolist(), err.tolist(), mag.tolist())))
        print(f"checkpoint {key}: total err {np.linalg.norm(err):.6f}")

    logger.finish()
    return results


if __name__ == "__main__":
    main()
