"""Serving: bucketed inference for a trained operator.

Counterpart of resolution_pde_tpu/deploy/serving.py ``ServingEngine``:
- **Buckets per (spatial shape, channels, batch)**: ``warmup`` runs each
  bucket once, which builds the CUDA kernels and allocates the memory the
  shapes need, so a first request pays neither.
- **Pad-and-slice**: a request of B rows runs on the smallest warmed
  bucket >= B, padded with its first row (the models are per-sample
  independent in eval mode), and the output is sliced back to B.
- **Normalizer round-trip**: encode(x) -> model -> decode(pred) on the
  device; ``forecast`` re-encodes each decoded step, as evaluation/rollout
  does.
"""

from __future__ import annotations

import warnings
from typing import Iterable, Sequence

import numpy as np
import torch

from resolution_pde_tpu_torch.models.registry import unwrap_output


def _as_shape_tuple(spatial) -> tuple:
    if isinstance(spatial, int):
        return (spatial,)
    return tuple(int(s) for s in spatial)


class ServingEngine:
    """Bucketed inference engine.

    model: an nn.Module mapping (B, C, *spatial) to (B, C_out, *spatial);
        it is moved to ``device`` and put in eval mode.
    x_normalizer / y_normalizer: optional SimpleNormalizer-likes (with
        ``to(device)``, ``encode`` and ``decode``).
    compute_dtype: cast x to this dtype before the model; outputs are
        always f32.
    strict_buckets: raise LookupError on a request no warmed bucket covers,
        instead of warming one inside the serving path.
    device: where the model runs; a CUDA device raises when CUDA is not
        available.
    """

    def __init__(self, model, *, x_normalizer=None, y_normalizer=None,
                 compute_dtype=None, strict_buckets: bool = False,
                 device="cpu"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"ServingEngine(device={str(device)!r}): CUDA "
                               "is not available")
        self.device = device
        self.model = model.to(device).eval()
        self.x_normalizer = (x_normalizer.to(device)
                             if x_normalizer is not None else None)
        self.y_normalizer = (y_normalizer.to(device)
                             if y_normalizer is not None else None)
        self.compute_dtype = compute_dtype
        self.strict_buckets = strict_buckets
        # (kind, spatial, in_channels, batch[, steps]) of every warmed bucket
        self._buckets: set = set()

    # -- the computation --------------------------------------------------

    def _model_step(self, x):
        if self.compute_dtype is not None:
            x = x.to(self.compute_dtype)
        return unwrap_output(self.model(x)).float()

    @torch.no_grad()
    def _predict(self, x):
        xn, yn = self.x_normalizer, self.y_normalizer
        pred = self._model_step(xn.encode(x) if xn is not None else x)
        return yn.decode(pred) if yn is not None else pred

    @torch.no_grad()
    def _forecast(self, x0, steps: int):
        xn, yn = self.x_normalizer, self.y_normalizer
        state = xn.encode(x0) if xn is not None else x0
        preds = []
        for _ in range(steps):
            pred = self._model_step(state)
            decoded = yn.decode(pred) if yn is not None else pred
            state = xn.encode(decoded) if xn is not None else decoded
            preds.append(decoded)
        return torch.stack(preds, dim=1)  # (B, steps, C, *spatial)

    # -- buckets ----------------------------------------------------------

    def compile_bucket(self, spatial, batch_size: int, in_channels: int = 1,
                       rollout_steps: Iterable[int] = ()) -> None:
        """Warm the predict (and optional forecast) bucket of one (spatial
        shape, batch): run it once on zeros."""
        spatial = _as_shape_tuple(spatial)
        x = torch.zeros((batch_size, in_channels) + spatial,
                        device=self.device)
        key = ("predict", spatial, in_channels, batch_size)
        if key not in self._buckets:
            self._predict(x)
            self._buckets.add(key)
        for steps in rollout_steps:
            k = ("forecast", spatial, in_channels, batch_size, int(steps))
            if k not in self._buckets:
                self._forecast(x, int(steps))
                self._buckets.add(k)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self, spatial_shapes: Sequence, batch_sizes: Sequence[int],
               in_channels: int = 1,
               rollout_steps: Iterable[int] = ()) -> None:
        """Warm every (spatial, batch) bucket ahead of serving."""
        rollout_steps = tuple(rollout_steps)
        for sp in spatial_shapes:
            for b in batch_sizes:
                self.compile_bucket(sp, b, in_channels=in_channels,
                                    rollout_steps=rollout_steps)

    def _bucket_for(self, kind: str, spatial: tuple, channels: int, b: int,
                    extra=()):
        """Smallest warmed batch bucket >= b for this (spatial shape,
        channel count); None when there is none."""
        candidates = sorted(
            k[3] for k in self._buckets
            if k[0] == kind and k[1] == spatial and k[2] == channels
            and tuple(k[4:]) == tuple(extra) and k[3] >= b)
        return candidates[0] if candidates else None

    def _on_bucket_miss(self, kind: str, spatial: tuple, channels: int,
                        b: int) -> None:
        msg = (f"ServingEngine bucket miss: no warmed {kind} bucket covers "
               f"(spatial={spatial}, channels={channels}, batch={b}); "
               f"warmed: {self.buckets()}")
        if self.strict_buckets:
            raise LookupError(msg + " (strict_buckets=True)")
        warnings.warn(msg + " — warming it inside the serving path",
                      RuntimeWarning, stacklevel=3)

    def _put(self, x: np.ndarray, bucket: int) -> torch.Tensor:
        """Pad to the bucket with copies of the first row; move to device."""
        b = x.shape[0]
        if b != bucket:
            pad = np.broadcast_to(x[:1], (bucket - b,) + x.shape[1:])
            x = np.concatenate([x, pad], axis=0)
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    # -- serving ----------------------------------------------------------

    def predict_device(self, x) -> torch.Tensor:
        """Like predict() but returns the bucket-padded f32 tensor on the
        device without waiting for it; slice to the request's batch."""
        x = np.asarray(x, np.float32)
        b, c, spatial = x.shape[0], x.shape[1], tuple(x.shape[2:])
        bucket = self._bucket_for("predict", spatial, c, b)
        if bucket is None:
            self._on_bucket_miss("predict", spatial, c, b)
            self.compile_bucket(spatial, b, in_channels=c)
            bucket = b
        return self._predict(self._put(x, bucket))

    def predict(self, x) -> np.ndarray:
        """x: raw (B, C, *spatial) float32. Returns the decoded predictions
        (B, C_out, *spatial) as float32 numpy."""
        b = np.asarray(x).shape[0]
        return self.predict_device(x)[:b].cpu().numpy()

    def forecast(self, x0, steps: int) -> np.ndarray:
        """Autoregressive rollout from raw x0 (B, C, *spatial). Returns the
        decoded (B, steps, C, *spatial) float32 numpy, with the normalizer
        round-trip between steps."""
        x0 = np.asarray(x0, np.float32)
        b, c, spatial = x0.shape[0], x0.shape[1], tuple(x0.shape[2:])
        bucket = self._bucket_for("forecast", spatial, c, b, (int(steps),))
        if bucket is None:
            self._on_bucket_miss("forecast", spatial, c, b)
            self.compile_bucket(spatial, b, in_channels=c,
                                rollout_steps=(int(steps),))
            bucket = b
        return self._forecast(self._put(x0, bucket),
                              int(steps))[:b].cpu().numpy()

    def buckets(self) -> list:
        """Warmed buckets: [(kind, spatial, in_channels, batch, *extra)]."""
        return sorted(self._buckets, key=str)
