"""Plotting and numeric export.

Counterpart of resolution_pde_tpu/utils/plotting.py: the same functions,
signatures, figures and file names. Arrays may be numpy arrays or torch
tensors (on any device, any float dtype); tensors are copied to host
float32 numpy at the boundary.

Parity target: utils/plot_utils.py (pred-vs-target grids, per-resolution
comparison plots, frequency retention/energy plots), rollout plots
(utils/autoregressive_step.py:355), frequency analysis plots
(utils/frequency_analysis_plot.py), and the CSV numeric dumps that accompany
each figure. matplotlib is imported lazily with the Agg backend so headless
runs work.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Optional, Sequence

import numpy as np


def _np(a, dtype=None):
    """numpy view of an array or a tensor (detached, on the host, bf16 and
    f16 widened to float32)."""
    if hasattr(a, "detach"):
        a = a.detach().cpu()
        if a.is_floating_point() and a.element_size() < 4:
            a = a.float()
        a = a.numpy()
    return np.asarray(a, dtype=dtype)


def _plot_data_np(plot_data):
    """{res: {name: array}} with every array as numpy."""
    return {r: {k: _np(v) for k, v in d.items()}
            for r, d in plot_data.items()}


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _ensure_dir(path: str):
    """Create the parent of a FILE path; for directories use _mkdir."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    return path


def _mkdir(dir_path: str):
    os.makedirs(os.path.abspath(dir_path), exist_ok=True)
    return dir_path


def plot_1d_predictions(predictions, targets, inputs=None, save_path=None,
                        title: str = "prediction vs target",
                        max_examples: int = 4):
    """Grid of 1D prediction-vs-target line plots (plot_utils pattern).

    predictions/targets: (N, C, X) or (N, X)."""
    plt = _plt()
    preds = _np(predictions)
    targs = _np(targets)
    if preds.ndim == 3:
        preds, targs = preds[:, 0], targs[:, 0]
    n = min(max_examples, len(preds))
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 3), squeeze=False)
    for i in range(n):
        ax = axes[0, i]
        ax.plot(targs[i], label="target", lw=1.5)
        ax.plot(preds[i], label="prediction", lw=1.0, ls="--")
        if inputs is not None:
            xi = _np(inputs)
            ax.plot(xi[i, 0] if xi.ndim == 3 else xi[i], label="input",
                    lw=0.8, alpha=0.5)
        ax.set_title(f"example {i}")
        if i == 0:
            ax.legend(fontsize=7)
    fig.suptitle(title)
    fig.tight_layout()
    if save_path:
        fig.savefig(_ensure_dir(save_path), dpi=120)
        plt.close(fig)
        return save_path
    return fig


def plot_2d_predictions(predictions, targets, save_path=None,
                        title: str = "prediction vs target",
                        max_examples: int = 3):
    """Rows of (target, prediction, |error|) heatmaps for 2D fields."""
    plt = _plt()
    preds = _np(predictions)
    targs = _np(targets)
    if preds.ndim == 4:
        preds, targs = preds[:, 0], targs[:, 0]
    n = min(max_examples, len(preds))
    fig, axes = plt.subplots(n, 3, figsize=(9, 3 * n), squeeze=False)
    for i in range(n):
        for j, (data, name) in enumerate(
                ((targs[i], "target"), (preds[i], "prediction"),
                 (np.abs(preds[i] - targs[i]), "|error|"))):
            im = axes[i, j].imshow(data, cmap="RdBu_r" if j < 2 else
                                   "magma")
            axes[i, j].set_title(name, fontsize=8)
            axes[i, j].axis("off")
            fig.colorbar(im, ax=axes[i, j], fraction=0.046)
    fig.suptitle(title)
    fig.tight_layout()
    if save_path:
        fig.savefig(_ensure_dir(save_path), dpi=120)
        plt.close(fig)
        return save_path
    return fig


def plot_super_resolution(results: Dict[int, float], save_path=None,
                          title: str = "super-resolution rel-L2",
                          train_res: Optional[int] = None):
    """rel-L2 vs resolution curve (the per-resolution table as a figure)."""
    plt = _plt()
    res = sorted(results)
    vals = [results[r] for r in res]
    fig, ax = plt.subplots(figsize=(5, 3.5))
    ax.plot(res, vals, "o-")
    ax.set_xscale("log", base=2)
    ax.set_yscale("log")
    ax.set_xlabel("resolution")
    ax.set_ylabel("relative L2")
    if train_res:
        ax.axvline(train_res, color="gray", ls=":", label="train res")
        ax.legend(fontsize=8)
    ax.set_title(title)
    fig.tight_layout()
    if save_path:
        fig.savefig(_ensure_dir(save_path), dpi=120)
        plt.close(fig)
        return save_path
    return fig


def plot_frequency_decomposition(error_per_mode, magnitude_per_mode,
                                 frequencies, save_path=None,
                                 title: str = "per-mode error"):
    """Error + solution magnitude vs frequency (frequency_analysis_plot)."""
    plt = _plt()
    error_per_mode, magnitude_per_mode, frequencies = (
        _np(error_per_mode), _np(magnitude_per_mode), _np(frequencies))
    fig, ax = plt.subplots(figsize=(5, 3.5))
    ax.semilogy(frequencies, np.maximum(error_per_mode, 1e-12),
                label="error")
    ax.semilogy(frequencies, np.maximum(magnitude_per_mode, 1e-12),
                label="solution magnitude", alpha=0.7)
    ax.set_xlabel("frequency (cycles/sample)")
    ax.set_ylabel("L2 norm")
    ax.legend(fontsize=8)
    ax.set_title(title)
    fig.tight_layout()
    if save_path:
        fig.savefig(_ensure_dir(save_path), dpi=120)
        plt.close(fig)
        return save_path
    return fig


def plot_rollout(trajectory, prediction, save_path=None,
                 title: str = "autoregressive rollout",
                 steps: Optional[Sequence[int]] = None):
    """1D rollout comparison: a few timesteps of truth vs prediction
    (autoregressive_step.py:355 pattern). trajectory (T, X), prediction
    (T, X)."""
    plt = _plt()
    traj = _np(trajectory)
    pred = _np(prediction)
    t = min(len(traj), len(pred))
    if steps is None:
        steps = sorted(set([0, t // 2, t - 1]))
    fig, axes = plt.subplots(1, len(steps), figsize=(4 * len(steps), 3),
                             squeeze=False)
    for i, s in enumerate(steps):
        axes[0, i].plot(traj[s], label="truth", lw=1.5)
        axes[0, i].plot(pred[s], label="prediction", lw=1.0, ls="--")
        axes[0, i].set_title(f"step {s}")
        if i == 0:
            axes[0, i].legend(fontsize=7)
    fig.suptitle(title)
    fig.tight_layout()
    if save_path:
        fig.savefig(_ensure_dir(save_path), dpi=120)
        plt.close(fig)
        return save_path
    return fig


def save_results_csv(results: Dict, path: str, columns=("key", "value")):
    """Numeric dump companion (plot_utils.py:234 / rollout CSV pattern)."""
    _ensure_dir(path)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(columns)
        for k in sorted(results):
            w.writerow([k, results[k]])
    return path


def plot_examples_multiple(plot_data: Dict[int, dict], pde: str = "PDE",
                           save_dir=None, num_examples: int = 5,
                           spatial_ndim: int = 1):
    """Per-resolution multi-example grids (plot_utils.py:25-182 /
    879-1050): rows = examples, cols = resolutions; 1D overlays
    prediction vs target, 2D shows prediction/target/|error| panels.

    plot_data: {res: {'inputs','predictions','targets'}} from
    evaluate_all_resolutions(n_plot_examples=...).
    """
    plt = _plt()
    plot_data = _plot_data_np(plot_data)
    resolutions = sorted(plot_data)
    if not resolutions:
        return None
    n_ex = min(num_examples,
               min(plot_data[r]["predictions"].shape[0]
                   for r in resolutions))
    if spatial_ndim == 1:
        fig, axes = plt.subplots(n_ex, len(resolutions),
                                 figsize=(4 * len(resolutions), 2.5 * n_ex),
                                 squeeze=False)
        for j, res in enumerate(resolutions):
            d = plot_data[res]
            for i in range(n_ex):
                ax = axes[i][j]
                ax.plot(d["targets"][i, 0], label="target", lw=1.0)
                ax.plot(d["predictions"][i, 0], "--", label="pred", lw=1.0)
                if i == 0:
                    ax.set_title(f"res {res}")
                if i == 0 and j == 0:
                    ax.legend(fontsize=7)
    else:
        fig, axes = plt.subplots(
            n_ex * 3, len(resolutions),
            figsize=(3 * len(resolutions), 2.2 * n_ex * 3), squeeze=False)
        for j, res in enumerate(resolutions):
            d = plot_data[res]
            for i in range(n_ex):
                pr, tg = d["predictions"][i, 0], d["targets"][i, 0]
                for k, (img, name) in enumerate(
                        ((pr, "pred"), (tg, "target"),
                         (np.abs(pr - tg), "|err|"))):
                    ax = axes[3 * i + k][j]
                    ax.imshow(img, cmap="viridis")
                    ax.set_xticks([])
                    ax.set_yticks([])
                    if j == 0:
                        ax.set_ylabel(f"ex{i} {name}", fontsize=7)
                    if i == 0 and k == 0:
                        ax.set_title(f"res {res}")
    fig.suptitle(f"{pde}: predictions across resolutions")
    fig.tight_layout()
    if save_dir:
        _mkdir(save_dir)
        path = os.path.join(save_dir, f"{pde}_examples_multi_res.png")
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return path
    return fig


def plot_ns_channels(plot_data: Dict[int, dict], save_dir=None,
                     num_examples: int = 2):
    """NS multi-channel plots + error maps (plot_utils.py:600-878): for
    each resolution, one row per (example, channel) with prediction,
    target, and signed error panels."""
    plt = _plt()
    plot_data = _plot_data_np(plot_data)
    paths = []
    for res in sorted(plot_data):
        d = plot_data[res]
        pred, tgt = d["predictions"], d["targets"]
        n_ex = min(num_examples, pred.shape[0])
        n_ch = pred.shape[1]
        fig, axes = plt.subplots(n_ex * n_ch, 3,
                                 figsize=(9, 2.6 * n_ex * n_ch),
                                 squeeze=False)
        for i in range(n_ex):
            for c in range(n_ch):
                row = i * n_ch + c
                pr, tg = pred[i, c], tgt[i, c]
                vmax = float(np.abs(tg).max()) or 1.0
                for k, (img, name, cmap, vlim) in enumerate((
                        (pr, "prediction", "viridis", None),
                        (tg, "target", "viridis", None),
                        (pr - tg, "error", "RdBu_r", vmax * 0.2))):
                    ax = axes[row][k]
                    kw = ({"vmin": -vlim, "vmax": vlim} if vlim else {})
                    im = ax.imshow(img, cmap=cmap, **kw)
                    fig.colorbar(im, ax=ax, fraction=0.046)
                    ax.set_title(f"ex{i} ch{c} {name}", fontsize=8)
                    ax.set_xticks([])
                    ax.set_yticks([])
        fig.suptitle(f"NS channels @ res {res}")
        fig.tight_layout()
        if save_dir:
            _mkdir(save_dir)
            path = os.path.join(save_dir, f"ns_channels_res{res}.png")
            fig.savefig(path, dpi=120)
            plt.close(fig)
            paths.append(path)
        else:
            paths.append(fig)
    return paths


def analyze_resize_frequencies(input_data, input_res: int, output_res: int,
                               save_dir=None):
    """Spectral-resize retention/energy analysis (plot_utils.py:309-564):
    what band-selection between input_res and output_res keeps, as spectrum
    images, retention fractions, and an energy summary. input_data:
    (1, 1, input_res, input_res)."""
    plt = _plt()
    x = _np(input_data, np.float32)
    f = np.fft.rfft2(x)
    out_h, out_w = output_res, output_res
    f_z = np.zeros((*x.shape[:-2], out_h, out_w // 2 + 1), dtype=f.dtype)
    # band selection bounds exactly as utils/res_utils.py resize()
    top1 = min((f.shape[-2] + 1) // 2, (out_h + 1) // 2)
    top2 = min(f.shape[-1], out_w // 2 + 1)
    bot1 = min(f.shape[-2] // 2, out_h // 2)
    f_z[..., :top1, :top2] = f[..., :top1, :top2]
    if bot1 > 0:
        f_z[..., -bot1:, :top2] = f[..., -bot1:, :top2]

    f_amp = np.abs(f[0, 0])
    fz_amp = np.abs(f_z[0, 0])
    energy_in = float((f_amp ** 2).sum())
    energy_out = float((fz_amp ** 2).sum())
    op = ("UPSAMPLING" if output_res > input_res
          else "DOWNSAMPLING" if output_res < input_res else "NO CHANGE")

    fig, axes = plt.subplots(2, 2, figsize=(11, 9))
    im = axes[0][0].imshow(np.log1p(f_amp), cmap="viridis", aspect="auto")
    axes[0][0].set_title(f"input spectrum {f.shape[-2]}x{f.shape[-1]}")
    fig.colorbar(im, ax=axes[0][0])
    im = axes[0][1].imshow(np.log1p(fz_amp), cmap="viridis", aspect="auto")
    axes[0][1].set_title(f"kept spectrum {f_z.shape[-2]}x{f_z.shape[-1]}")
    fig.colorbar(im, ax=axes[0][1])
    axes[1][0].bar(["freq bins kept", "spatial rows kept"],
                   [top2 / f.shape[-1], (top1 + bot1) / f.shape[-2]])
    axes[1][0].set_ylim(0, 1.05)
    axes[1][0].set_title("retention fractions")
    axes[1][1].axis("off")
    axes[1][1].text(
        0.02, 0.5,
        f"{input_res} -> {output_res} ({op})\n"
        f"energy retained: {100.0 * energy_out / max(energy_in, 1e-30):.2f}%\n"
        f"rows copied: top {top1}, bottom {bot1}\n"
        f"cols copied: {top2} / {f.shape[-1]}",
        fontsize=11, va="center", family="monospace")
    fig.suptitle(f"FFT resize frequency analysis ({op})")
    fig.tight_layout()
    if save_dir:
        _mkdir(save_dir)
        path = os.path.join(
            save_dir, f"resize_freq_{input_res}_to_{output_res}.png")
        fig.savefig(path, dpi=120)
        plt.close(fig)
        return path
    return fig


def plot_frequency_analysis(frequency_data, pde: str = "pde",
                            current_res=None, save_dir=None):
    """Combined multi-resolution frequency analysis figure
    (utils/frequency_analysis_plot.py:9-129): error-per-mode overlay
    across resolutions, the solution spectral decay, and the normalized
    error/|solution| overlay, in one 2x2 panel.

    frequency_data: {res: (error_per_mode, magnitude_per_mode, freqs)} —
    the finalized decompositions from evaluate_all_resolutions.
    Returns the saved path (or None if matplotlib is unavailable)."""
    plt = _plt()
    if plt is None or not frequency_data:
        return None
    frequency_data = {r: tuple(_np(a) for a in v)
                      for r, v in frequency_data.items()}
    resolutions = sorted(frequency_data)
    fig, axes = plt.subplots(2, 2, figsize=(14, 10))
    colors = plt.cm.viridis(np.linspace(0, 1, len(resolutions)))

    for idx, res in enumerate(resolutions):
        err, mag, freqs = frequency_data[res]
        axes[0, 0].semilogy(freqs, err, label=f"Res {res}",
                            color=colors[idx], linewidth=2, marker="o",
                            markersize=3)
        axes[1, 0].semilogy(freqs, err / (mag + 1e-10),
                            label=f"Res {res}", color=colors[idx],
                            linewidth=2, marker="o", markersize=3)
    axes[0, 0].set_xlabel("Frequency (cycles per sample)")
    axes[0, 0].set_ylabel("L2 Error per Mode (log scale)")
    axes[0, 0].set_title("Error Decomposition by Fourier Mode")
    axes[0, 0].legend(fontsize=9)
    axes[0, 0].grid(True, alpha=0.3)

    err0, mag0, freqs0 = frequency_data[resolutions[0]]
    axes[0, 1].semilogy(freqs0, mag0, "b-", linewidth=2)
    axes[0, 1].set_xlabel("Frequency (cycles per sample)")
    axes[0, 1].set_ylabel("Solution Magnitude (log scale)")
    axes[0, 1].set_title(f"{pde.upper()} Solution Spectral Decay")
    axes[0, 1].grid(True, alpha=0.3)

    axes[1, 0].set_xlabel("Frequency (cycles per sample)")
    axes[1, 0].set_ylabel("Normalized Error (log scale)")
    axes[1, 0].set_title("Normalized Error: Error/Solution Magnitude")
    axes[1, 0].legend(fontsize=9)
    axes[1, 0].grid(True, alpha=0.3)
    axes[1, 1].axis("off")

    title = f"{pde.upper()}: Frequency Analysis"
    if current_res is not None:
        title += f" (Trained on {current_res})"
    fig.suptitle(title, fontsize=14, y=0.995)
    fig.tight_layout()
    path = None
    if save_dir is not None:
        _mkdir(save_dir)
        path = os.path.join(save_dir, f"{pde}_frequency_analysis.png")
        fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return path
