"""Serving: bucketed inference for a trained operator.

Counterpart of resolution_pde_tpu/deploy/serving.py ``ServingEngine``:
- **One CUDA graph per (spatial shape, channels, batch) bucket** on the
  card, the counterpart of the JAX package's AOT-compiled program per
  bucket: ``compile_bucket`` runs the bucket once eagerly on a side stream
  (which builds the kernel library, makes cuFFT's plans and fills the
  kernel planners' caches) and then captures its predict, and each
  forecast length, into a ``torch.cuda.CUDAGraph`` with static input and
  output buffers. A request copies its padded input into the static
  input, replays the graph and copies the output out, so its latency is
  one graph launch and two copies, not a launch from Python per kernel.
  Every bucket's graph allocates from one memory pool. A capture that
  fails raises: the card never serves eagerly. On the CPU the engine
  runs eagerly.
- **Pad-and-slice**: a request of B rows runs on the smallest warmed
  bucket >= B, padded with its first row (the models are per-sample
  independent in eval mode), and the output is sliced back to B.
- **Normalizer round-trip**: encode(x) -> model -> decode(pred) on the
  device; ``forecast`` re-encodes each decoded step, as evaluation/rollout
  does, and on the card its whole loop is one graph, as JAX's forecast is
  one ``lax.scan`` program.

- **Mesh** (``mesh=``, a DeviceMesh of parallel/mesh.py): the
  parameters are whole on every rank, and a bucket's rows are split over
  the data axes ("dcn" x "data", extent n): each rank captures (or runs)
  its bucket / n rows, and after the replay the outputs are gathered over
  the data group, outside the graph (gloo's collectives cannot be
  captured), so every rank returns the whole output; ``forecast`` runs
  its whole rollout per rank and gathers once. A bucket must be a
  multiple of n. Every rank of the data group serves each request (the
  gather is a collective).

The kernels' launch counters (``ops/kernels/*.launches``) count launches
from the host, so a graph's kernels count once, at capture, and not at
each replay.

``stats()`` counts, as plain ints, the requests served and their rows,
the rows padded up to a bucket and the bucket misses (a strict engine's
refused request counts as a miss). Operators size the buckets from them:
a non-strict engine warms a missed bucket inside the serving path, and a
padded row is work thrown away.

While a profiler records, each request opens these spans
(``utils/tracing.py``; none otherwise), so that a profile of the engine
puts the device's idle time and each kernel under the part of the request
the host was in:
  - ``rpde.serve.predict`` (``predict``, ``predict_device``) or
    ``rpde.serve.forecast``, the whole request;
  - inside it ``rpde.serve.warm`` (a bucket warmed on a miss),
    ``rpde.serve.pad`` (padded to the bucket), ``rpde.serve.copy_in`` (into
    the graph's static input, or to the device), ``rpde.serve.replay``
    (``graph.replay()``, or the eager run), ``rpde.serve.gather`` (under a
    mesh) and ``rpde.serve.copy_out`` (``.cpu().numpy()``, which waits for
    the device).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np
import torch

from resolution_pde_tpu_torch.models.registry import unwrap_output
from resolution_pde_tpu_torch.ops.kernels._cost import count_operations
from resolution_pde_tpu_torch.parallel.collectives import gather_tensor
from resolution_pde_tpu_torch.parallel.mesh import (data_axis_size,
                                                    data_group, data_rank)
from resolution_pde_tpu_torch.utils.tracing import span


def _as_shape_tuple(spatial) -> tuple:
    if isinstance(spatial, int):
        return (spatial,)
    return tuple(int(s) for s in spatial)


@dataclass
class _BucketGraph:
    """A captured bucket: replaying ``graph`` reads ``x`` and writes
    ``out``."""

    graph: torch.cuda.CUDAGraph
    x: torch.Tensor
    out: torch.Tensor


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
    device: where the model runs, the card unless the caller asks for
        the CPU; a CUDA device raises when CUDA is not available.
    mesh: optional DeviceMesh; each bucket's rows split over its data
        axes (see the module docstring).
    """

    def __init__(self, model, *, x_normalizer=None, y_normalizer=None,
                 compute_dtype=None, strict_buckets: bool = False,
                 device="cuda", mesh=None):
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
        self.mesh = mesh
        self._n = data_axis_size(mesh)
        self._group = data_group(mesh) if self._n > 1 else None
        self._rank = data_rank(mesh)
        # (kind, spatial, in_channels, batch[, steps]) of every warmed
        # bucket -> its _BucketGraph on the card, None on the CPU
        self._programs: dict = {}
        # serve through the graphs; a private switch, so a check can run
        # the same engine eagerly beside them
        self._use_graphs = device.type == "cuda"
        self._pool = None
        self._stream = None
        self._stats = dict(requests=0, rows=0, padded_rows=0,
                           bucket_misses=0)

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

    def _fn(self, key):
        if key[0] == "predict":
            return self._predict
        return lambda x: self._forecast(x, key[4])

    # -- buckets ----------------------------------------------------------

    def _capture(self, fn, shape) -> _BucketGraph:
        """Run ``fn`` once eagerly on the engine's side stream, then
        capture it into a graph on that stream, allocating from the
        engine's pool. Buckets are replayed one at a time and each
        request copies its output out before the next replay, so the
        graphs may share the pool's memory."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        x = torch.zeros(shape, device=self.device)
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            fn(x)
        torch.cuda.current_stream(self.device).wait_stream(self._stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
            out = fn(x)
        return _BucketGraph(graph, x, out)

    def _shape(self, key) -> tuple:
        """The input shape this rank runs for bucket ``key``: its rows."""
        return (key[3] // self._n, key[2]) + key[1]

    def _warm(self, key) -> None:
        if key in self._programs:
            return
        shape = self._shape(key)
        if self.device.type == "cuda":
            self._programs[key] = self._capture(self._fn(key), shape)
        else:
            self._fn(key)(torch.zeros(shape, device=self.device))
            self._programs[key] = None

    def compile_bucket(self, spatial, batch_size: int, in_channels: int = 1,
                       rollout_steps: Iterable[int] = ()) -> None:
        """Warm the predict (and optional forecast) bucket of one (spatial
        shape, batch): on the card, capture each into a CUDA graph; on the
        CPU, run it once on zeros. Under a mesh the batch must be a
        multiple of the data extent, and each rank warms its rows."""
        if batch_size % self._n:
            raise ValueError(f"bucket of {batch_size} rows does not divide "
                             f"over the data extent {self._n}")
        spatial = _as_shape_tuple(spatial)
        self._warm(("predict", spatial, in_channels, batch_size))
        for steps in rollout_steps:
            self._warm(("forecast", spatial, in_channels, batch_size,
                        int(steps)))
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
            k[3] for k in self._programs
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

    @staticmethod
    def _pad(x: np.ndarray, bucket: int) -> torch.Tensor:
        """Pad to the bucket with copies of the first row, as a CPU
        tensor."""
        b = x.shape[0]
        if b != bucket:
            pad = np.broadcast_to(x[:1], (bucket - b,) + x.shape[1:])
            x = np.concatenate([x, pad], axis=0)
        return torch.from_numpy(np.ascontiguousarray(x))

    def _run(self, key, x: np.ndarray) -> torch.Tensor:
        """The bucket ``key`` on x padded to it: the graph's output buffer
        (valid until its next replay), or the eager result; under a mesh,
        this rank's rows run and the outputs are gathered (a new
        tensor)."""
        stats = self._stats
        stats["requests"] += 1
        stats["rows"] += x.shape[0]
        stats["padded_rows"] += key[3] - x.shape[0]
        with span("rpde.serve.pad"):
            xb = self._pad(x, key[3])
        per = key[3] // self._n
        xb = xb[self._rank * per:(self._rank + 1) * per]
        if self._use_graphs:
            bg = self._programs[key]
            with span("rpde.serve.copy_in"):
                bg.x.copy_(xb)
            with span("rpde.serve.replay"):
                bg.graph.replay()
            out = bg.out
        else:
            with span("rpde.serve.copy_in"):
                xb = xb.to(self.device)
            with span("rpde.serve.replay"):
                out = self._fn(key)(xb)
        if self._group is not None:
            with span("rpde.serve.gather"):
                out = gather_tensor(out, self._group, 0)
        return out

    def _key(self, kind: str, x: np.ndarray, extra=()) -> tuple:
        """The bucket a request runs on, warmed on a miss."""
        b, c, spatial = x.shape[0], x.shape[1], tuple(x.shape[2:])
        bucket = self._bucket_for(kind, spatial, c, b, extra)
        if bucket is None:
            self._stats["bucket_misses"] += 1
            self._on_bucket_miss(kind, spatial, c, b)
            bucket = -(-b // self._n) * self._n  # a multiple of the extent
            with span("rpde.serve.warm"):
                self.compile_bucket(spatial, bucket, in_channels=c,
                                    rollout_steps=extra)
        return (kind, spatial, c, bucket) + tuple(extra)

    # -- serving ----------------------------------------------------------

    def predict_device(self, x) -> torch.Tensor:
        """Like predict() but returns the bucket-padded f32 tensor on the
        device without waiting for it (a copy: a graph's output buffer is
        overwritten by its next replay); slice to the request's batch."""
        with span("rpde.serve.predict"):
            x = np.asarray(x, np.float32)
            out = self._run(self._key("predict", x), x)
            return out.clone() if self._use_graphs and self._n == 1 else out

    def predict(self, x) -> np.ndarray:
        """x: raw (B, C, *spatial) float32. Returns the decoded predictions
        (B, C_out, *spatial) as float32 numpy."""
        with span("rpde.serve.predict"):
            x = np.asarray(x, np.float32)
            out = self._run(self._key("predict", x), x)[:x.shape[0]]
            with span("rpde.serve.copy_out"):
                return out.cpu().numpy()

    def forecast(self, x0, steps: int) -> np.ndarray:
        """Autoregressive rollout from raw x0 (B, C, *spatial). Returns the
        decoded (B, steps, C, *spatial) float32 numpy, with the normalizer
        round-trip between steps."""
        with span("rpde.serve.forecast"):
            x0 = np.asarray(x0, np.float32)
            key = self._key("forecast", x0, (int(steps),))
            out = self._run(key, x0)[:x0.shape[0]]
            with span("rpde.serve.copy_out"):
                return out.cpu().numpy()

    # -- introspection ----------------------------------------------------

    def stats(self) -> dict:
        """{"requests", "rows", "padded_rows", "bucket_misses"}, counted
        since the engine was made: requests served and their rows, rows
        padded up to a bucket, and requests no warmed bucket covered."""
        return dict(self._stats)

    def buckets(self) -> list:
        """Warmed buckets: [(kind, spatial, in_channels, batch, *extra)]."""
        return sorted(self._programs, key=str)

    def cost_summary(self) -> dict:
        """{str(bucket): {"flops": ...}} for every warmed bucket: one eager
        run of the bucket on zeros under FlopCounterMode (PyTorch's
        operators: its matrix products and convolutions; it counts no
        FFT), plus each hand kernel's own operation count for the shapes
        it was launched with (``ops/kernels/_cost.py``), which
        FlopCounterMode cannot see; under a mesh, this rank's rows of
        each bucket. On the CPU the kernels' plain versions
        run and FlopCounterMode counts their products instead. No count of
        bytes covers a whole bucket, so "bytes accessed" is left out: an
        absent entry is a backend limitation, as in the JAX package."""
        from torch.utils.flop_counter import FlopCounterMode

        out = {}
        for key in self.buckets():
            x = torch.zeros(self._shape(key), device=self.device)
            counter = FlopCounterMode(display=False)
            with count_operations() as tally, counter:
                self._fn(key)(x)
            out[str(key)] = {"flops": float(counter.get_total_flops()
                                            + tally["operations"])}
        return out

    # -- construction helpers ---------------------------------------------

    @classmethod
    def from_checkpoint(cls, model, checkpoint_path: str, sample_x=None,
                        **engine_kwargs) -> "ServingEngine":
        """An engine serving the parameters of a trained checkpoint (the
        port's format, ``train/checkpoint.py``) restored into ``model``,
        on ``engine_kwargs``' device (the card by default). The model may
        take another route than the one it trained on (an S4Model with
        ``kernel_impl='pallas'`` for weights trained on 'jnp': the
        parameters are the same). ``sample_x`` is kept for the JAX
        package's signature, where it builds the restore template; a
        torch model holds its parameters, so it is not used."""
        from resolution_pde_tpu_torch.train import Trainer
        from resolution_pde_tpu_torch.train.checkpoint import (
            restore_checkpoint)

        trainer = Trainer(model, device=engine_kwargs.get("device", "cuda"))
        state, _ = restore_checkpoint(checkpoint_path, trainer.init())
        return cls(state.model, **engine_kwargs)
