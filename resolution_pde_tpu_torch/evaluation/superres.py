"""Super-resolution evaluation sweep.

Counterpart of resolution_pde_tpu/evaluation/superres.py (reference
utils/naive_utils.py:30-214, utils/resize_utils.py:27-43, 216-233): per
target resolution the caller's ``dataset_builder(res)`` rebuilds the raw
test pairs at that resolution; inputs are encoded with the train
resolution's x normalizer (per-location stats adapted to the grid), the
prediction decoded with the y normalizer, and the batch-mean relative L2
averaged over batches. A resolution that fails is recorded as NaN (or
raised with ``strict``). ``resize_to_train`` FFT-resizes the input to the
train resolution and the prediction back.

The model is a torch module; the forward runs on its device under
``torch.inference_mode()`` in eval mode (no dropout, the JAX package's
``deterministic=True``), the batch losses add up on the device and are
fetched once per resolution. ``mesh=`` (parallel/mesh.py) shards each
eval batch over the data axes ("dcn" x "data"; the whole grid on every
"spatial" rank; an indivisible one padded with zero-weight rows):
each rank sums its rows' relative L2 over the batch's size, and the sums
are added over the ranks once per resolution, so the batch mean is the
global one; the frequency sums add up over the ranks' real rows, and the
plotted examples are the global batch's first rows.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from resolution_pde_tpu_torch.evaluation.frequency import (
    finalize_frequency_1d,
    finalize_frequency_2d,
    spectrum_sums_1d,
    spectrum_sums_2d,
)
from resolution_pde_tpu_torch.models.registry import unwrap_output
from resolution_pde_tpu_torch.ops.losses import relative_l2
from resolution_pde_tpu_torch.ops.normalizers import adapt_normalizer
from resolution_pde_tpu_torch.ops.resize import fft_resize_1d, fft_resize_2d
from resolution_pde_tpu_torch.parallel.collectives import gather_tensor
from resolution_pde_tpu_torch.parallel.mesh import (data_group,
                                                    local_weights,
                                                    shard_batch)


def get_lower_resolutions(base_resolution: int, min_resolution: int = 32):
    """[32, 64, ..., base] by halving (resize_utils.py:27-43)."""
    resolutions = []
    res = base_resolution // 2
    while res >= min_resolution:
        resolutions.insert(0, res)
        res = res // 2
    return resolutions + [base_resolution]


def _resize_spatial(x, target: int, ndim: int):
    if ndim == 1:
        return fft_resize_1d(x, target)
    return fft_resize_2d(x, (target, target))


def model_device(model) -> torch.device:
    return next(model.parameters()).device


def on_device(norm, device):
    """A normalizer with its stats on ``device`` (None stays None)."""
    return norm.to(device) if norm is not None else None


def normalized_forward(model, bx, x_normalizer=None, y_normalizer=None,
                       spatial_ndim: int = 1):
    """Encode bx, run the model, decode the prediction; per-location stats
    adapted to bx's grid."""
    sp = bx.shape[-spatial_ndim:]
    xn = adapt_normalizer(x_normalizer, sp)
    yn = adapt_normalizer(y_normalizer, sp)
    if xn is not None:
        bx = xn.encode(bx)
    pred = unwrap_output(model(bx))
    return yn.decode(pred) if yn is not None else pred


def evaluate_all_resolutions(
    model,
    dataset_builder: Callable,
    current_res: int,
    test_resolutions=None,
    max_test_resolution: Optional[int] = None,
    x_normalizer=None,
    y_normalizer=None,
    batch_size: int = 16,
    spatial_ndim: int = 1,
    resize_to_train: bool = False,
    analyze_frequencies: bool = False,
    strict: bool = False,
    n_plot_examples: int = 0,
    mesh=None,
) -> dict:
    """Evaluate at every resolution of the ladder.

    Returns {'results': {res: rel_l2},
             'frequency_data': {res: (error_per_mode, magnitude, freqs)},
             'plot_data': {res: {inputs, predictions, targets}},
             'seconds': {res: wall seconds, the dataset build included}};
    plot_data holds the first n_plot_examples samples per resolution.
    mesh: shard each batch over its data axes (module docstring).
    """
    if test_resolutions is None:
        test_resolutions = get_lower_resolutions(
            max_test_resolution or current_res)
    device = model_device(model)
    x_normalizer = on_device(x_normalizer, device)
    y_normalizer = on_device(y_normalizer, device)

    def forward(bx):
        return normalized_forward(model, bx, x_normalizer, y_normalizer,
                                  spatial_ndim)

    def forward_resized(bx):
        pred = forward(_resize_spatial(bx, current_res, spatial_ndim))
        return _resize_spatial(pred, bx.shape[-1], spatial_ndim)

    group = data_group(mesh)
    results: Dict[int, float] = {}
    frequency_data, plot_data, seconds = {}, {}, {}
    was_training = model.training
    model.eval()
    try:
        for target_res in test_resolutions:
            t0 = time.perf_counter()
            try:
                ds = dataset_builder(target_res)
                fn = (forward_resized
                      if resize_to_train and target_res != current_res
                      else forward)
                total, n = None, 0
                err_acc = mag_acc = None
                with torch.inference_mode():
                    for i in range(0, len(ds), batch_size):
                        bx, by = ds.x[i:i + batch_size], ds.y[i:i + batch_size]
                        rows = real = len(bx)
                        if mesh is not None:
                            (bx, by), pw = shard_batch((bx, by), mesh)
                            real = (len(bx) if pw is None else
                                    int(local_weights(pw, mesh).sum()))
                        bx = torch.as_tensor(bx, device=device)
                        by = torch.as_tensor(by, device=device)
                        pred = fn(bx)
                        if mesh is None:
                            loss = relative_l2(pred, by)
                        else:
                            loss = relative_l2(pred[:real], by[:real],
                                               reduction="sum") / rows
                        total = loss if total is None else total + loss
                        n += 1
                        if n_plot_examples > 0 and target_res not in plot_data:
                            shown = (bx, pred.float(), by)
                            if group is not None:
                                shown = [gather_tensor(t, group)[:rows]
                                         for t in shown]
                            k = min(n_plot_examples, rows)
                            plot_data[target_res] = dict(zip(
                                ("inputs", "predictions", "targets"),
                                (t[:k].cpu().numpy() for t in shown)))
                        if analyze_frequencies:
                            sums = (spectrum_sums_1d if spatial_ndim == 1
                                    else spectrum_sums_2d)(pred[:real].float(),
                                                           by[:real])
                            spatial_shape = by.shape[by.ndim - spatial_ndim:]
                            if err_acc is None:
                                err_acc, mag_acc = sums
                            else:
                                err_acc = err_acc + sums[0]
                                mag_acc = mag_acc + sums[1]
                    if group is not None and total is not None:
                        # the ranks' shares, added once per resolution
                        parts = [total] + ([err_acc, mag_acc]
                                           if err_acc is not None else [])
                        for t in parts:
                            torch.distributed.all_reduce(t, group=group)
                # one host fetch per resolution
                results[target_res] = (float(total) if total is not None
                                       else 0.0) / max(n, 1)
                if analyze_frequencies and err_acc is not None:
                    frequency_data[target_res] = (
                        finalize_frequency_1d(err_acc, mag_acc,
                                              spatial_shape[-1])
                        if spatial_ndim == 1 else
                        finalize_frequency_2d(err_acc, mag_acc,
                                              *spatial_shape))
            except Exception as e:  # a failed resolution is recorded as NaN
                if strict:
                    raise
                print(f"resolution {target_res} failed: {e!r}")
                results[target_res] = float("nan")
            seconds[target_res] = time.perf_counter() - t0
    finally:
        model.train(was_training)
    return {"results": results, "frequency_data": frequency_data,
            "plot_data": plot_data, "seconds": seconds}
