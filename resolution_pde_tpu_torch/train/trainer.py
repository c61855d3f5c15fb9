"""Training and evaluation harness.

Counterpart of resolution_pde_tpu/train/trainer.py (reference semantics of
train/training.py:19-147):
  - per batch: forward, the y-normalizer's decode of prediction AND target
    before the loss (with ``use_normalizer``), relative L2 (weighted batch
    mean), one AdamW step;
  - ``accum_steps`` > 1: the batch split into that many microbatches, a
    batch that does not divide padded with zero-weight rows, each
    microbatch's loss and gradient weighted by its count of real rows, one
    optimizer step;
  - BatchNorm models (CNO, UNet): each microbatch's forward runs in
    train mode, so the running statistics (buffers, not parameters: no
    weight decay, as flax's ``batch_stats``; the norms' weight and bias
    are decayed, as flax's scale and bias) move once a microbatch, in the
    microbatches' order, as JAX threads ``batch_stats`` through its scan;
    the zero-weight rows padding a straggler batch enter that
    microbatch's statistics in both;
  - per epoch: the mean of the batch losses (one host sync per epoch), a
    validation pass with the same decode, the scheduler stepped once after
    the epoch (ReduceLROnPlateau sees the validation loss), then
    ``epoch_callback``;
  - ``evaluate``: per-batch mean relative L2 averaged over batches.

The optimizer is the JAX package's optax chain (clip_by_global_norm,
scale_by_adam, add_decayed_weights(1e-4) masked off the S4 state-space
parameters (``models.s4.SSM_PARAM_NAMES``), scale by -lr): that is
``torch.optim.AdamW(lr, betas=(0.9, 0.999), eps=1e-8)`` over two groups,
``weight_decay`` for the others and 0 for those (an empty group is left
out, so a model without them has one group), with
the clip written out as optax writes it (scale by c / ||g|| when
||g|| >= c; ``clip_grad_norm_`` would add 1e-6 to the norm). With
``ssm_lr`` the state-space group trains at ``ratio * lr``, ratio =
min(ssm_lr, lr) / lr, which optax writes as ``scale(ratio)`` masked to
those parameters inside one injected rate: ``set_lr`` keeps the ratio, so
they anneal with the main rate. Dropout draws
from one ``torch.Generator`` on the device, seeded with ``seed + 1``, which
the checkpoint saves. Batches are staged in pinned host memory and copied
with ``non_blocking``, one batch ahead of the step that uses them.

``profile_step`` traces steps with ``torch.profiler`` where JAX uses
``jax.profiler``. While a profiler records, the trainer opens these spans
(``utils/tracing.py``; none otherwise), which divide a profiled step and
its device time into its phases:
  - ``rpde.train.step``: each ``train_step`` (its stage inside it) and
    each step of ``train_epoch`` (whose batches are staged one ahead);
  - ``rpde.train.stage``: ``_stage`` of a training batch (in
    ``train_step`` and ``train_epoch``'s prefetch, not evaluation's), the
    rows taken, pinned and copied to the device without blocking;
  - ``rpde.train.forward`` (model and loss), ``rpde.train.backward``
    (``backward()``), one of each a microbatch, and
    ``rpde.train.optimizer`` (gradient reduction, clip, ``opt.step()``).

``mesh`` (a DeviceMesh of parallel/mesh.py; inside an initialized process
group ``None`` means ``make_mesh()``, every rank on "data", the JAX
Trainer's default) runs each step on this rank's rows of the global batch
over the data axes, "dcn" x "data" (``shard_batch``; models with
BatchNorm take ``straggler="replicate"``). With a "spatial" extent S >
1 a train step also shards the grid's H axis of x and y over it (JAX's
``batch_sharding(mesh, 4, spatial_axis=2)``) and runs the model on the
slabs inside ``parallel.spatial.sharded`` (FFNO2D and FNO2d: a model
without ``spatial_sharding`` raises a ValueError here), a y-normalizer
with per-location statistics taking the rank's rows; every spatial rank
computes the same loss, and the gradients are summed over "spatial" too.
Evaluation keeps the whole grid on every rank.
There is one step: without a mesh (or at a data extent of 1) the rows
are the batch, the share is the batch's loss, and the collectives are
left out.
JAX's loss over a padded batch is sum(w rel) / sum(w) over the global
batch, so each rank divides its own sum(w rel) by the global sum(w) (or
its batch mean by the data extent), and the gradients are then SUMMED over
"data", not averaged: DDP's averaging would weigh a straggler batch's
ranks alike. The loss returned is the global one; BatchNorm takes the
global batch's statistics (``models.norms.sync_batch_stats``), and a
``grad_clip`` the global norm over the shards. ``param_specs`` ({name:
spec}: ``fsdp_specs``, ``ffno_tp_specs``, ``moe_ep_specs``,
``merge_specs``) shards the model before the optimizer is built
(parallel/shard.py; FSDP through torch's ``fully_shard``), so the
optimizer holds the shards and their moments.
Dropout draws each rank's rows' masks from the one seeded generator, so
multi-rank runs match the single process at dropout 0. Not ported:
``auto_layout`` (an XLA layout tool).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

import torch
import torch.distributed as dist
from torch import nn

from resolution_pde_tpu_torch.models.layers import Dropout
from resolution_pde_tpu_torch.models.norms import BatchNorm, sync_batch_stats
from resolution_pde_tpu_torch.models.registry import unwrap_output
from resolution_pde_tpu_torch.models.s4 import SSM_PARAM_NAMES
from resolution_pde_tpu_torch.ops.losses import relative_l2
from resolution_pde_tpu_torch.parallel import spatial
from resolution_pde_tpu_torch.parallel.mesh import (axis_size,
                                                    data_axis_size,
                                                    data_group,
                                                    local_weights,
                                                    make_mesh, shard_batch)
from resolution_pde_tpu_torch.parallel.shard import (grad_sq_norm, local_part,
                                                     reduce_gradients,
                                                     shard_module,
                                                     split_dtensors)
from resolution_pde_tpu_torch.train.schedules import ReduceLROnPlateau
from resolution_pde_tpu_torch.utils.tracing import span


@dataclass
class TrainState:
    """What a training run carries from step to step: the model (whose
    parameters are the JAX state's ``params``), the AdamW optimizer
    (``opt_state``), the step count and the dropout generator
    (``dropout_key``). The trainer updates it in place and returns it, so
    call sites read as the JAX package's."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    dropout_generator: torch.Generator


@dataclass
class History:
    train_loss: list = field(default_factory=list)
    val_loss: list = field(default_factory=list)
    lr: list = field(default_factory=list)
    epoch_time_s: list = field(default_factory=list)


def _ssm_ids(model: nn.Module) -> set:
    """ids of the model's state-space parameters (``SSM_PARAM_NAMES``)."""
    return {id(p) for name, p in model.named_parameters()
            if name.rsplit(".", 1)[-1] in SSM_PARAM_NAMES}


class Trainer:
    """Runs train and eval steps of ``model`` on ``device``, the card unless
    the caller asks for the CPU; the model is moved there, and a CUDA
    device raises when CUDA is not available. ``model(x)`` returns a
    prediction with the layout of y (or {'output': prediction})."""

    def __init__(self, model: nn.Module, learning_rate: float = 1e-3,
                 weight_decay: float = 1e-4, use_normalizer: bool = False,
                 y_normalizer=None, grad_clip: Optional[float] = None,
                 ssm_lr: Optional[float] = None, seed: int = 0,
                 accum_steps: int = 1, device="cuda", mesh=None,
                 param_specs: Optional[dict] = None):
        """ssm_lr: the S4 family's state-space parameters
        (``SSM_PARAM_NAMES``) train at min(ssm_lr, learning_rate), with no
        weight decay, and anneal in proportion with the main rate (JAX
        Trainer, the reference's ``_optim`` attributes). mesh and
        param_specs: see the module docstring."""
        if int(accum_steps) < 1:
            raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"Trainer(device={str(device)!r}): CUDA is "
                               "not available")
        self.device = device
        self.model = model.to(device)
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.use_normalizer = use_normalizer
        self.y_normalizer = (y_normalizer.to(self.device)
                             if y_normalizer is not None else None)
        self.grad_clip = grad_clip
        self.seed = seed
        self.accum_steps = int(accum_steps)
        self.ssm_ratio = (min(ssm_lr, learning_rate) / learning_rate
                          if ssm_lr is not None else 1.0)
        if mesh is None and dist.is_available() and dist.is_initialized():
            mesh = make_mesh(device_type=device.type)
        self.mesh = mesh
        if (axis_size(mesh, "spatial") > 1
                and not getattr(model, "spatial_sharding", False)):
            raise ValueError(
                f"{type(model).__name__} does not run with the grid sharded "
                "over 'spatial' (FFNO2D and FNO2d do): use a mesh with a "
                "'spatial' extent of 1")
        if param_specs is not None:
            if mesh is None:
                raise ValueError("param_specs need a mesh")
            shard_module(self.model, mesh, param_specs)
        self._batch_stats = any(isinstance(m, BatchNorm)
                                for m in self.model.modules())
        self._data_group = data_group(mesh)

    # -- state ----------------------------------------------------------
    def init(self) -> TrainState:
        """A fresh optimizer over the model's current parameters, step 0,
        and the dropout generator, which every Dropout of the model then
        draws from."""
        ssm_ids = _ssm_ids(self.model)
        decayed = [p for p in self.model.parameters()
                   if id(p) not in ssm_ids]
        ssm = [p for p in self.model.parameters() if id(p) in ssm_ids]
        # an empty group is left out; FSDP's DTensor parameters are a
        # group of their own
        groups = ([dict(params=part, weight_decay=self.weight_decay)
                   for part in split_dtensors(decayed)]
                  + [dict(params=part, weight_decay=0.0,
                          lr=self.ssm_ratio * self.learning_rate)
                     for part in split_dtensors(ssm)])
        opt = torch.optim.AdamW(groups, lr=self.learning_rate,
                                betas=(0.9, 0.999), eps=1e-8)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed + 1)
        for m in self.model.modules():
            if isinstance(m, Dropout):
                m.generator = gen
        return TrainState(model=self.model, optimizer=opt, step=0,
                          dropout_generator=gen)

    def set_lr(self, state: TrainState, lr: float) -> TrainState:
        """The main rate ``lr``; the state-space group's ``ratio * lr``."""
        ssm_ids = _ssm_ids(state.model)
        for group in state.optimizer.param_groups:
            is_ssm = id(group["params"][0]) in ssm_ids
            group["lr"] = self.ssm_ratio * lr if is_ssm else lr
        return state

    def current_lr(self, state: TrainState) -> float:
        """The main rate (the state-space group's over the ratio where the
        model has no other parameter)."""
        group = state.optimizer.param_groups[0]
        if id(group["params"][0]) in _ssm_ids(state.model):
            return float(group["lr"]) / self.ssm_ratio
        return float(group["lr"])

    # -- steps ----------------------------------------------------------
    def _to_device(self, a) -> torch.Tensor:
        """Host array or tensor -> tensor on the device; float64 becomes
        float32, as JAX's arrays do. From the host the copy goes through
        pinned memory without blocking the host."""
        t = torch.as_tensor(a)
        if t.dtype == torch.float64:
            t = t.float()
        if self.device.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _decode_for_loss(self, pred, y, y_normalizer):
        if self.use_normalizer and y_normalizer is not None:
            pred = y_normalizer.decode(pred)
            y = y_normalizer.decode(y)
        return pred, y

    def _clip_grads(self, params) -> None:
        """optax.clip_by_global_norm: g -> g / ||g|| * c when ||g|| >= c,
        decided on the device (no host sync); ||g|| over the shards of a
        sharded model."""
        params = list(params)
        norm = torch.sqrt(grad_sq_norm(params, self.mesh))
        c = self.grad_clip
        for p in params:
            if p.grad is not None:
                g = local_part(p.grad)
                g.copy_(torch.where(norm < c, g, g / norm * c))

    def _stage(self, x, y, weights=None, straggler=None,
               train=False) -> tuple:
        """This rank's rows of the global batch on the device, with what
        its loss share divides by: (x, y, w, total, copies). w: the rows'
        weights (None: unweighted); total: the global sum of weights
        (None: unweighted); copies: the data extent where every rank holds
        the whole batch (straggler "replicate"), else 1. Without a mesh,
        the batch itself. ``train``: with a "spatial" extent above 1, x
        and y are the rank's slabs (their axis 2 sharded)."""
        if straggler is None:
            straggler = "replicate" if self._batch_stats else "pad"
        n = data_axis_size(self.mesh)
        b = x.shape[0]
        replicated = n > 1 and b % n != 0 and straggler == "replicate"
        local, pad_w = shard_batch((x, y), self.mesh, straggler,
                                   spatial_axis=2 if train else None)
        w = total = None
        if weights is not None:
            (w,), _ = shard_batch((weights,), self.mesh, straggler)
            total = float(torch.as_tensor(weights).float().sum())
        if pad_w is not None:
            pm = local_weights(pad_w, self.mesh)
            w = pm if w is None else torch.as_tensor(w) * torch.as_tensor(pm)
            total = float(b) if total is None else total
        x, y = self._to_device(local[0]), self._to_device(local[1])
        if w is not None:
            w = self._to_device(w).float()
        return x, y, w, total, (n if replicated else 1)

    def _loss(self, model, x, y, w, total, copies, y_normalizer):
        """This rank's share of the global batch's mean relative L2, from
        its rows (x, y) (``_stage``'s w, total and copies); without a
        mesh, the batch's mean."""
        pred = unwrap_output(model(x))
        pred, target = self._decode_for_loss(pred, y, y_normalizer)
        if w is None:
            return relative_l2(pred, target) / data_axis_size(self.mesh)
        return (relative_l2(pred, target, reduction="sum", weights=w)
                / (max(total, 1.0) * copies))

    def train_step(self, state: TrainState, x, y, weights=None) -> tuple:
        """One optimizer step on the batch (x, y); weights: optional (B,)
        per-sample loss weights. Returns (state, loss) with the loss a
        0-dim tensor on the device. Under a mesh every rank passes the
        same global batch and takes its rows."""
        with span("rpde.train.step"):
            with span("rpde.train.stage"):
                staged = self._stage(x, y, weights, train=True)
            return self._step(state, *staged)

    def _step(self, state, x, y, w, total, copies) -> tuple:
        """The step on ``_stage``'s output. accum_steps > 1: the rows in
        that many microbatches (padded with zero-weight copies of row 0,
        which still enter a BatchNorm's statistics, as in JAX), each
        microbatch's loss its weighted share of the whole."""
        model, opt = state.model, state.optimizer
        model.train()
        opt.zero_grad(set_to_none=True)
        n = data_axis_size(self.mesh)
        sync = self._data_group if copies == 1 and n > 1 else None
        accum = self.accum_steps
        with sync_batch_stats(model, sync), \
                spatial.sharded(self.mesh) as shard:
            y_normalizer = self._local_normalizer(shard, y.shape[2:])
            if accum == 1:
                with span("rpde.train.forward"):
                    loss = self._loss(model, x, y, w, total, copies,
                                      y_normalizer)
                with span("rpde.train.backward"):
                    loss.backward()
                loss = loss.detach()
            else:
                rows = x.shape[0]
                if w is None:
                    w = torch.ones(rows, device=x.device)
                    total = float(rows * n // copies)
                pad = (-rows) % accum
                if pad:
                    x = torch.cat([x, x[:1].expand(pad, *x.shape[1:])])
                    y = torch.cat([y, y[:1].expand(pad, *y.shape[1:])])
                    w = torch.cat([w, torch.zeros(pad, device=w.device)])
                mb = (rows + pad) // accum
                loss = torch.zeros((), device=x.device)
                for i in range(accum):
                    part = slice(i * mb, (i + 1) * mb)
                    with span("rpde.train.forward"):
                        li = self._loss(model, x[part], y[part], w[part],
                                        total, copies, y_normalizer)
                    with span("rpde.train.backward"):
                        li.backward()
                    loss = loss + li.detach()
        with span("rpde.train.optimizer"):
            reduce_gradients(model.parameters(), self.mesh)
            if self._data_group is not None:
                dist.all_reduce(loss, group=self._data_group)
            if self.grad_clip:
                self._clip_grads(model.parameters())
            opt.step()
        state.step += 1
        return state, loss

    def _local_normalizer(self, shard, slab):
        """The y-normalizer for a step's targets: as it is, or inside a
        sharded step, its per-location statistics cut to the rank's rows
        of the whole grid (H = the slab's rows x S)."""
        yn = self.y_normalizer
        if shard is None or yn is None or not hasattr(yn, "mean"):
            return yn
        h = slab[0] * shard.size
        return type(yn)(spatial.rows_of(yn.mean, h, shard),
                        spatial.rows_of(yn.std, h, shard), yn.eps,
                        device=yn.mean.device)

    @torch.no_grad()
    def eval_step(self, state: TrainState, x, y,
                  y_normalizer="trainer") -> torch.Tensor:
        if y_normalizer == "trainer":
            y_normalizer = self.y_normalizer
        state.model.eval()
        share = self._loss(state.model, *self._stage(x, y, None, "pad"),
                           y_normalizer)
        if self._data_group is not None:
            dist.all_reduce(share, group=self._data_group)
        return share

    def profile_step(self, state: TrainState, x, y, trace_dir: str,
                     n_steps: int = 5) -> tuple:
        """Trace ``n_steps`` train steps on (x, y), after one to warm up,
        with torch.profiler (CPU activity, and CUDA's on the card); the
        Chrome trace, which holds the trainer's ``rpde.*`` spans, goes into
        ``trace_dir``. Returns (state, trace_dir)."""
        state, loss = self.train_step(state, x, y)
        float(loss)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n_steps):
                state, loss = self.train_step(state, x, y)
            float(loss)
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            trace_dir, f"train_step_{state.step}.pt.trace.json"))
        return state, trace_dir

    # -- loops ----------------------------------------------------------
    def _prefetch(self, loader: Iterable, straggler=None, train=False):
        """Start each batch's host-to-device copy before the step on the
        batch ahead of it runs, so copy and step overlap; each batch is
        this rank's rows with their loss normalisation (``_stage``)."""
        pending = None
        for batch in loader:
            with (span("rpde.train.stage") if train
                  else contextlib.nullcontext()):
                nxt = self._stage(*batch[:3], straggler=straggler,
                                  train=train)
            if pending is not None:
                yield pending
            pending = nxt
        if pending is not None:
            yield pending

    def train_epoch(self, state: TrainState, loader: Iterable) -> tuple:
        """One pass over ``loader`` (an iterable of (x, y) batches).
        Returns (state, mean batch loss as a float)."""
        losses = []
        for staged in self._prefetch(loader, train=True):
            with span("rpde.train.step"):
                state, loss = self._step(state, *staged)
            losses.append(loss)
        # one host sync per epoch, not per batch
        total = float(torch.stack(losses).sum()) if losses else 0.0
        return state, total / max(len(losses), 1)

    @torch.no_grad()
    def evaluate(self, state: TrainState, loader: Iterable,
                 y_normalizer="trainer") -> float:
        """Average per-batch mean relative L2 (reference evaluate(),
        train/training.py:105-146)."""
        if y_normalizer == "trainer":
            y_normalizer = self.y_normalizer
        state.model.eval()
        losses = [self._loss(state.model, *staged, y_normalizer)
                  for staged in self._prefetch(loader, "pad")]
        if not losses:
            return 0.0
        # the ranks' shares add up once, after the last batch
        total = torch.stack(losses).sum()
        if self._data_group is not None:
            dist.all_reduce(total, group=self._data_group)
        return float(total) / len(losses)

    def fit(self, state: TrainState,
            train_loader_fn: Callable[[], Iterable] | Iterable,
            val_loader_fn: Callable[[], Iterable] | Iterable | None = None,
            epochs: int = 1,
            schedule: Callable[[int], float] | ReduceLROnPlateau | None = None,
            log_fn: Callable[[dict], None] | None = None,
            epoch_callback: Callable[[int, TrainState, History], None]
            | None = None) -> tuple:
        """Epoch loop with the scheduler stepped after each epoch.

        Loaders may be factories (called each epoch, so a shuffling
        pipeline draws anew) or re-iterable objects. epoch_callback(epoch,
        state, history_so_far) runs after each epoch's scheduler step and
        logging: the periodic-checkpoint hook.
        """
        history = History()
        for epoch in range(epochs):
            t0 = time.perf_counter()
            loader = (train_loader_fn() if callable(train_loader_fn)
                      else train_loader_fn)
            state, train_loss = self.train_epoch(state, loader)
            history.train_loss.append(train_loss)

            val_loss = float("nan")
            if val_loader_fn is not None:
                vloader = (val_loader_fn() if callable(val_loader_fn)
                           else val_loader_fn)
                val_loss = self.evaluate(state, vloader)
            history.val_loss.append(val_loss)

            # scheduler: stepped AFTER the epoch, plateau sees val loss
            if isinstance(schedule, ReduceLROnPlateau):
                state = self.set_lr(state, schedule.step(val_loss))
            elif schedule is not None:
                state = self.set_lr(state, schedule(epoch + 1))
            history.lr.append(self.current_lr(state))
            history.epoch_time_s.append(time.perf_counter() - t0)

            if log_fn is not None:
                log_fn({"epoch": epoch, "train_loss": train_loss,
                        "val_loss": val_loss, "lr": history.lr[-1],
                        "epoch_time_s": history.epoch_time_s[-1]})
            if epoch_callback is not None:
                epoch_callback(epoch, state, history)
        return state, history

