"""CNO's resize training: every batch is antialias-resized to the model's
fixed training resolution inside the loop.

Counterpart of resolution_pde_tpu/train/cno_resize.py (reference
train/interpolate_training.py:19-147, dead code there; the JAX package's
is the working version): the bicubic antialiased resize
(``ops.interpolation``) of x and y to ``train_size`` before the forward
pass. The resize runs on the trainer's device: ``ResizingLoader`` copies a
batch there first (``device``, the card unless the caller passes the CPU;
through pinned memory without blocking the host, as the Trainer copies),
so the host hands over the batch at its stored resolution.
"""

from __future__ import annotations

from typing import Iterable

import torch

from resolution_pde_tpu_torch.ops.interpolation import (bicubic_resize_1d,
                                                        bicubic_resize_2d)


def resize_batch_to(x: torch.Tensor, train_size: int,
                    spatial_ndim: int) -> torch.Tensor:
    """Antialiased bicubic resize of (B, C, *spatial) to train_size; a
    batch already at that size is returned as it is."""
    if spatial_ndim == 1:
        if x.shape[-1] == train_size:
            return x
        return bicubic_resize_1d(x, train_size)
    if x.shape[-1] == train_size and x.shape[-2] == train_size:
        return x
    return bicubic_resize_2d(x, (train_size, train_size))


class ResizingLoader:
    """Wraps a loader of (x, y) batches, each moved to ``device`` and
    resized to train_size: feed it to ``Trainer.fit`` for CNO's resize
    training."""

    def __init__(self, loader: Iterable, train_size: int,
                 spatial_ndim: int = 1, device="cuda"):
        self.loader = loader
        self.train_size = train_size
        self.spatial_ndim = spatial_ndim
        self.device = torch.device(device)

    def _resized(self, a) -> torch.Tensor:
        t = torch.as_tensor(a)
        if t.dtype == torch.float64:
            t = t.float()
        if self.device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return resize_batch_to(t.to(self.device), self.train_size,
                               self.spatial_ndim)

    def __iter__(self):
        for x, y in self.loader:
            yield self._resized(x), self._resized(y)

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch: int):
        """Passes a resume's epoch on to the wrapped loader's shuffle."""
        if hasattr(self.loader, "set_epoch"):
            self.loader.set_epoch(epoch)


def cno_train(trainer, state, train_loader, val_loader, train_size: int,
              spatial_ndim: int = 1, **fit_kwargs):
    """Train with the batches resized in the loop."""
    wrap = lambda loader: ResizingLoader(  # noqa: E731
        loader, train_size, spatial_ndim, trainer.device)
    return trainer.fit(
        state, wrap(train_loader),
        wrap(val_loader) if val_loader is not None else None, **fit_kwargs)


def cno_evaluate(trainer, state, loader, train_size: int,
                 spatial_ndim: int = 1) -> float:
    """Evaluate with the batches resized in the loop."""
    return trainer.evaluate(state, ResizingLoader(loader, train_size,
                                                  spatial_ndim,
                                                  trainer.device))
